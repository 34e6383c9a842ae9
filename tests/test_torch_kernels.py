"""The port's kernel modules against the JAX package, on the CPU.

On a CPU tensor the dispatch takes each kernel's plain PyTorch version,
so these tests hold the plain versions (the arithmetic the CUDA kernels
repeat, which ``chip_smoke.py`` checks on the card) against:

* the Pallas kernel bodies run with ``interpret=True``;
* the JAX gather oracle ``repro.kernels.ref`` and ``qdot``.

Inputs are numpy arrays from a seed, quantized once and handed to both
sides, so both read the same bytes.  Tolerances:

* plain vs the JAX oracle, 2e-6: the same gather-then-softmax algorithm,
  only the float summation order of the two libraries differs;
* plain vs the Pallas body, the JAX package's own kernel-vs-oracle
  bands (2e-6 fp32, 1e-5 int8, 1e-4 int4): online softmax over pages
  against one global softmax;
* matmuls, 2e-5 of the output's scale: one f32 contraction in another
  order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.paged_attention import paged_attention_pallas
from repro.kernels.quant_matmul import quant_matmul_pallas
from repro.quant.qlinear import qdot as jax_qdot
from repro.quant.qtypes import W4_SYM_GROUP, W8_SYM_CHANNEL
from repro.quant.quantize import (lane_major_scales, pack_int4, quantize,
                                  quantize_kv_int4, quantize_kv_int8)
from repro_torch.bridge import params_from_jax
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention import paged_attention_plain
from repro_torch.kernels.quant_matmul import quant_matmul_plain
from repro_torch.quant.qlinear import qdot

PALLAS_TOL = {"fp32": 2e-6, "int8": 1e-5, "int4": 1e-4}
PAGE = 8


def _pools(quant, kf, vf):
    """Float pools -> numpy (k_pages, v_pages, k_scale, v_scale)."""
    if quant == "fp32":
        return kf, vf, None, None
    fn = quantize_kv_int8 if quant == "int8" else quantize_kv_int4
    k, ks = fn(jnp.asarray(kf))
    v, vs = fn(jnp.asarray(vf))
    if quant == "int4":
        k, v = pack_int4(k, axis=1), pack_int4(v, axis=1)
    return tuple(np.asarray(a) for a in
                 (k, v, lane_major_scales(ks), lane_major_scales(vs)))


def _fixture(seed, B, H, KV, D, n_entries, lengths):
    rng = np.random.default_rng(seed)
    P = B * n_entries + 1
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    kf = rng.normal(size=(P, PAGE, KV, D)).astype(np.float32)
    vf = rng.normal(size=(P, PAGE, KV, D)).astype(np.float32)
    bt = rng.permutation(np.arange(1, P))[:B * n_entries].reshape(
        B, n_entries).astype(np.int32)
    return q, kf, vf, bt, np.asarray(lengths, np.int32)


CASES = {
    # mode: (n_entries, window, ring, lengths) — ragged, with a 0
    "full": (3, 0, False, [5, 21, 0, 24, 1, 9]),
    "window": (4, 7, False, [5, 21, 0, 32, 17, 8]),
    "ring": (3, 12, True, [0, 5, 16, 17, 33, 47]),
}


def _run_both(quant, mode, H, KV, D, pallas: bool):
    n_entries, window, ring, lengths = CASES[mode]
    q, kf, vf, bt, ln = _fixture(H * 7 + KV, len(lengths), H, KV, D,
                                 n_entries, lengths)
    kp, vp, ks, vs = _pools(quant, kf, vf)
    jargs = [jnp.asarray(a) for a in (q, kp, vp, bt, ln)]
    jkw = dict(window=window, ring=ring,
               k_scale=None if ks is None else jnp.asarray(ks),
               v_scale=None if vs is None else jnp.asarray(vs))
    o_ref = np.asarray(ref.paged_attention_ref(*jargs, **jkw))
    o_pal = (np.asarray(paged_attention_pallas(*jargs, interpret=True, **jkw))
             if pallas else None)
    targs = [torch.from_numpy(np.ascontiguousarray(a))
             for a in (q, kp, vp, bt, ln)]
    tkw = dict(window=window, ring=ring,
               k_scale=None if ks is None else torch.from_numpy(np.ascontiguousarray(ks)),
               v_scale=None if vs is None else torch.from_numpy(np.ascontiguousarray(vs)))
    o_plain = paged_attention_plain(*targs, **tkw).numpy()
    # the dispatch sends a CPU tensor to the plain version
    np.testing.assert_array_equal(ops.paged_attention(*targs, **tkw).numpy(),
                                  o_plain)
    np.testing.assert_allclose(o_plain, o_ref, rtol=2e-6, atol=2e-6)
    zero = [i for i, l in enumerate(lengths) if l == 0]
    assert zero and np.all(o_plain[zero] == 0.0)
    return o_plain, o_pal


@pytest.mark.parametrize("quant", ["fp32", "int8", "int4"])
@pytest.mark.parametrize("mode", ["full", "window", "ring"])
def test_paged_attention_plain_matches_jax(quant, mode):
    """fp32/int8/int4 pools x full/window/ring tables, GQA G=2, ragged
    lengths with a 0: plain vs the JAX oracle and the Pallas body."""
    o_plain, o_pal = _run_both(quant, mode, 4, 2, 16, pallas=True)
    assert np.max(np.abs(o_plain - o_pal)) <= PALLAS_TOL[quant]


@pytest.mark.parametrize("quant", ["fp32", "int8", "int4"])
@pytest.mark.parametrize("mode", ["full", "window", "ring"])
def test_paged_attention_plain_matches_ref_gqa8(quant, mode):
    """Eight query heads on one KV head, D=32: plain vs the JAX oracle."""
    _run_both(quant, mode, 8, 1, 32, pallas=False)


def test_paged_attention_window_query_not_ported():
    q = torch.zeros((1, 2, 4, 8))
    kp = torch.zeros((2, PAGE, 2, 8))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        paged_attention_plain(q, kp, kp, torch.zeros((1, 1), dtype=torch.int32),
                              torch.ones(1, dtype=torch.int32))


def _rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M,K,N", [(128, 128, 128), (128, 256, 384)])
def test_quant_matmul_plain_matches_pallas(bits, M, K, N):
    x = _rand(M + bits, M, K)
    cfg = W8_SYM_CHANNEL if bits == 8 else W4_SYM_GROUP
    t = quantize(jnp.asarray(_rand(K + N, K, N)), cfg)
    group = 0 if bits == 8 else cfg.group_size
    scale = (t.scale.reshape(1, N) if bits == 8
             else t.scale.reshape(K // group, 1, N))
    o_pal = np.asarray(quant_matmul_pallas(
        jnp.asarray(x), t.q, scale, bits=bits, group=group, interpret=True,
        out_dtype=jnp.float32))
    o_plain = quant_matmul_plain(
        torch.from_numpy(x), torch.from_numpy(np.asarray(t.q)),
        torch.from_numpy(np.asarray(scale)), bits=bits, group=group).numpy()
    np.testing.assert_allclose(o_plain, o_pal, rtol=2e-5,
                               atol=2e-5 * np.abs(o_pal).max())


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M", [1, 3, 8])
def test_qdot_matches_jax_at_decode_rows(bits, M):
    """Decode M (live slots) is 1..8, and K, N need not be multiples of
    128: the port sends every such shape to the matmul, the JAX qdot to
    its reference.  Bytes of the quantized weight pass through the
    bridge unchanged."""
    K, N = 192, 80
    cfg = W8_SYM_CHANNEL if bits == 8 else W4_SYM_GROUP
    jw = quantize(jnp.asarray(_rand(bits, K, N) * 0.05), cfg)
    tw = params_from_jax({"global": {"w": jw}, "groups": []})["global"]["w"]
    np.testing.assert_array_equal(tw.q.numpy(), np.asarray(jw.q))
    x = _rand(100 + M, M, K)
    o_jax = np.asarray(jax_qdot(jnp.asarray(x), jw))
    o_port = qdot(torch.from_numpy(x), tw).numpy()
    np.testing.assert_allclose(o_port, o_jax, rtol=2e-5,
                               atol=2e-5 * np.abs(o_jax).max())
    # leading dims collapse the same way
    x3 = _rand(200 + M, 2, M, K)
    np.testing.assert_allclose(
        qdot(torch.from_numpy(x3), tw).numpy(),
        np.asarray(jax_qdot(jnp.asarray(x3), jw)), rtol=2e-5,
        atol=2e-5 * np.abs(o_jax).max())


def test_dispatch_rejects_unknown_impl():
    x = torch.zeros((2, 64))
    w = params_from_jax({"global": {"w": quantize(
        jnp.ones((64, 8)), W8_SYM_CHANNEL)}, "groups": []})["global"]["w"]
    with pytest.raises(ValueError):
        ops.quant_matmul(x, w, impl="kernel")


def test_cuda_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never fall back: given CPU tensors they raise
    before any build or launch."""
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.kernels.quant_matmul import quant_matmul_cuda
    q = torch.zeros((1, 2, 8))
    kp = torch.zeros((2, PAGE, 1, 8))
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_cuda(q, kp, kp, torch.zeros((1, 1), dtype=torch.int32),
                             torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        quant_matmul_cuda(torch.zeros((1, 64)),
                          torch.zeros((64, 8), dtype=torch.int8),
                          torch.ones(8))
