"""The port's per-row quantization (``repro_torch.kernels.quantize_rowwise``)
against the JAX package, on the CPU.

On a CPU tensor ``ops.quantize_rowwise`` takes the plain version, the
arithmetic the CUDA kernel repeats (``chip_smoke.py`` holds the kernel to
it byte for byte on the card).  Inputs are numpy arrays from a seed,
handed to both packages.

The two JAX functions disagree with each other in the last bit: the
oracle ``ref.quantize_rowwise_ref`` divides ``max(amax, 1e-8) / qmax``,
while the Pallas body, run in interpret mode, multiplies by the rounded
reciprocal of ``qmax``, so some of its scales are one ulp off (and a
code can then round the other way; JAX's own
``test_quantize_rowwise_sweep`` allows rtol 1e-6 on scales and one code
step).  The port divides, as the kernel's source does, so it is held to
the ORACLE exactly: equal q bytes and bit-identical scales.  Against the
Pallas body it is held to JAX's own band, exact wherever the two JAX
functions agree.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.quantize_kernel import quantize_rowwise_pallas
from repro_torch.kernels import ops
from repro_torch.kernels.quantize_rowwise import (quantize_rowwise_cuda,
                                                  quantize_rowwise_plain)


def _x(seed, M, K):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    x[1] = 0.0                             # amax under the 1e-8 floor
    x[2, :4] = [0.5, -0.5, 1.5, -2.5]      # ties at scale 1
    x[2, 4:] = 0.0
    x[2, 4] = 127.0 if K > 4 else x[2, 4]
    return x


def _port(x, bits):
    q, s = ops.quantize_rowwise(torch.from_numpy(x), bits=bits)
    return q.numpy(), s.numpy()


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M,K", [(128, 64), (256, 320), (128, 1152)])
def test_quantize_rowwise_matches_jax(M, K, bits):
    """bits 8 and 4, M in {128, 256}: the port equals the JAX oracle
    exactly, and the Pallas body within its own band, exactly where the
    Pallas scale equals the oracle's."""
    x = _x(M + K + bits, M, K)
    q, s = _port(x, bits)
    assert q.dtype == np.int8 and q.shape == (M, K)
    assert s.dtype == np.float32 and s.shape == (M, 1)
    qr, sr = (np.asarray(a) for a in ref.quantize_rowwise_ref(jnp.asarray(x),
                                                              bits=bits))
    np.testing.assert_array_equal(q, qr)
    np.testing.assert_array_equal(s.view(np.int32), sr.view(np.int32))
    qk, sk = (np.asarray(a) for a in quantize_rowwise_pallas(
        jnp.asarray(x), bits=bits, interpret=True))
    np.testing.assert_allclose(s, sk, rtol=1e-6)
    assert np.abs(q.astype(np.int32) - qk.astype(np.int32)).max() <= 1
    same = (sk == sr)[:, 0]
    np.testing.assert_array_equal(q[same], qk[same])
    qmax = (1 << (bits - 1)) - 1
    assert q.min() >= -qmax - 1 and q.max() <= qmax
    # the 4-bit codes stay one per int8, and the zero row sits at the floor
    assert np.all(q[1] == 0) and s[1, 0] == np.float32(1e-8) / np.float32(qmax)


@pytest.mark.parametrize("bits", [8, 4])
def test_pallas_scale_disagreement_is_jax_own(bits):
    """Where the Pallas body's scale differs from the oracle's, it is the
    amax times the rounded reciprocal of qmax, and the oracle's (and the
    port's) is the true quotient: the disagreement lies between the two
    JAX functions, not in the port."""
    x = _x(7 + bits, 128, 64)
    qmax = np.float32((1 << (bits - 1)) - 1)
    amax = np.maximum(np.abs(x).max(axis=-1, keepdims=True), np.float32(1e-8))
    quotient = (amax / qmax).astype(np.float32)
    reciprocal = (amax * (np.float32(1) / qmax)).astype(np.float32)
    _, sk = quantize_rowwise_pallas(jnp.asarray(x), bits=bits, interpret=True)
    _, sr = ref.quantize_rowwise_ref(jnp.asarray(x), bits=bits)
    _, s = _port(x, bits)
    np.testing.assert_array_equal(np.asarray(sr), quotient)
    np.testing.assert_array_equal(s, quotient)
    np.testing.assert_array_equal(np.asarray(sk), reciprocal)
    assert np.any(quotient != reciprocal)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M,K", [(1, 7), (37, 1152), (8, 5632)])
def test_quantize_rowwise_ragged_matches_ref(M, K, bits):
    """Any M and K (the Pallas wrapper asserts M % 128 == 0, so only the
    oracle takes these): equal bytes and scales."""
    x = np.random.default_rng(M * K + bits).normal(size=(M, K)).astype(
        np.float32) * 3.0
    q, s = _port(x, bits)
    qr, sr = ref.quantize_rowwise_ref(jnp.asarray(x), bits=bits)
    np.testing.assert_array_equal(q, np.asarray(qr))
    np.testing.assert_array_equal(s, np.asarray(sr))


def test_quantize_rowwise_dispatch_and_refusals():
    """A CPU tensor takes the plain version and counts no launch; the CUDA
    wrapper refuses CPU tensors before any build; bits other than 4 or 8
    are refused."""
    x = torch.randn((4, 16))
    ops.reset_launch_counts()
    q, s = ops.quantize_rowwise(x, bits=8)
    pq, ps = quantize_rowwise_plain(x, bits=8)
    assert torch.equal(q, pq) and torch.equal(s, ps)
    assert ops.launch_counts()["quantize_rowwise"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        quantize_rowwise_cuda(x)
    with pytest.raises(ValueError, match="bits"):
        ops.quantize_rowwise(x, bits=2)
    with pytest.raises(ValueError):
        ops.quantize_rowwise(x, impl="pallas")
