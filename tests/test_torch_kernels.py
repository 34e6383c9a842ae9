"""The port's kernel modules against the JAX package, on the CPU.

On a CPU tensor the dispatch takes each kernel's plain PyTorch version,
so these tests hold the plain versions (the arithmetic the CUDA kernels
repeat, which ``chip_smoke.py`` checks on the card) against:

* the Pallas kernel bodies run with ``interpret=True``;
* the JAX oracles ``repro.kernels.ref`` and ``qdot``.

Inputs are numpy arrays from a seed, quantized once and handed to both
sides, so both read the same bytes.  Tolerances:

* plain vs the JAX oracle, 2e-6: the same gather-then-softmax algorithm,
  only the float summation order of the two libraries differs;
* plain vs the Pallas body, the JAX package's own kernel-vs-oracle
  bands (2e-6 fp32, 1e-5 int8, 1e-4 int4): online softmax over pages
  against one global softmax;
* flash attention, 2e-6 against both (unit-variance inputs, outputs of
  order 1): one softmax or an online one over 128-key tiles, in f32;
* matmuls, 2e-5 of the output's scale: one f32 contraction in another
  order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.paged_attention import paged_attention_pallas
from repro.kernels.quant_matmul import quant_matmul_pallas
from repro.quant.qlinear import qdot as jax_qdot
from repro.quant.qtypes import W4_SYM_GROUP, W8_SYM_CHANNEL
from repro.quant.quantize import (lane_major_scales, pack_int4, quantize,
                                  quantize_kv_int4, quantize_kv_int8)
from repro_torch.bridge import params_from_jax
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_plain
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


def _fixture(seed, B, H, KV, D, n_entries, lengths, K=0):
    """Pools, tables and lengths; q (B, H, D), or a K-token window
    (B, K, H, D) when K > 0."""
    rng = np.random.default_rng(seed)
    P = B * n_entries + 1
    q = rng.normal(size=(B, K, H, D) if K else (B, H, D)).astype(np.float32)
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


def _run_both(quant, mode, H, KV, D, pallas: bool, K=0):
    n_entries, window, ring, lengths = CASES[mode]
    q, kf, vf, bt, ln = _fixture(H * 7 + KV + K, len(lengths), H, KV, D,
                                 n_entries, lengths, K)
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


@pytest.mark.parametrize("K", [2, 4])
@pytest.mark.parametrize("quant", ["fp32", "int8", "int4"])
@pytest.mark.parametrize("mode", ["full", "window", "ring"])
def test_paged_attention_window_plain_matches_jax(quant, mode, K):
    """K-token verify windows, q (B, K, H, D): fp32/int8/int4 pools x
    full/window/ring tables, GQA G=2, ragged lengths with a 0 and some
    shorter than K (queries before position 0 see no key): plain vs the
    JAX window oracle and the Pallas window body."""
    o_plain, o_pal = _run_both(quant, mode, 4, 2, 16, pallas=True, K=K)
    assert o_plain.shape == (6, K, 4, 16)
    assert np.max(np.abs(o_plain - o_pal)) <= PALLAS_TOL[quant]


@pytest.mark.parametrize("K", [0, 4])
@pytest.mark.parametrize("quant", ["fp32", "int8", "int4"])
@pytest.mark.parametrize("mode", ["full", "window", "ring"])
def test_paged_attention_plain_matches_jax_gemma3_heads(quant, mode, K):
    """Gemma3-1B's head shapes: 4 query heads on ONE KV head of dim 256,
    single queries (K=0) and 4-token verify windows: plain vs the JAX
    oracle (2e-6) and the Pallas body (its own bands)."""
    o_plain, o_pal = _run_both(quant, mode, 4, 1, 256, pallas=True, K=K)
    assert np.max(np.abs(o_plain - o_pal)) <= PALLAS_TOL[quant]


def test_paged_attention_window_of_one_is_single_query():
    """A 1-token window is the single-query call: same positions, same
    masks, same numbers."""
    n_entries, window, ring, lengths = CASES["window"]
    q, kf, vf, bt, ln = _fixture(3, len(lengths), 4, 2, 16, n_entries, lengths)
    args = [torch.from_numpy(a) for a in (q, kf, vf, bt, ln)]
    one = paged_attention_plain(args[0][:, None], *args[1:], window=window)
    torch.testing.assert_close(one[:, 0], paged_attention_plain(
        *args, window=window), rtol=1e-6, atol=1e-6)


def _rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("Sq,Sk,H,KV", [(128, 128, 4, 2), (128, 256, 4, 1),
                                        (256, 256, 2, 2)])
def test_flash_attention_plain_matches_jax(Sq, Sk, H, KV, window):
    """Causal prompt attention with and without a sliding window, GQA,
    end-aligned queries (Sq < Sk): plain vs the JAX oracle and the
    Pallas body (128-row tiles)."""
    B, D = 2, 16
    q, k, v = (_rand(Sq + Sk + H, B, Sq, H, D), _rand(Sk + KV, B, Sk, KV, D),
               _rand(Sk + 7, B, Sk, KV, D))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    o_ref = np.asarray(ref.flash_attention_ref(jq, jk, jv, causal=True,
                                               window=window))
    o_pal = np.asarray(flash_attention_pallas(jq, jk, jv, causal=True,
                                              window=window, interpret=True))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o_plain = flash_attention_plain(tq, tk, tv, causal=True,
                                    window=window).numpy()
    np.testing.assert_array_equal(
        ops.flash_attention(tq, tk, tv, causal=True, window=window).numpy(),
        o_plain)
    assert o_plain.shape == (B, Sq, H, D)
    np.testing.assert_allclose(o_plain, o_ref, rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(o_plain, o_pal, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("window", [0, 48])
def test_flash_attention_plain_matches_jax_gemma3_heads(window):
    """Gemma3-1B's head shapes (H=4, KV=1, D=256), Sq=Sk=128: plain vs
    the JAX oracle and the Pallas body, 2e-6."""
    S, H, KV, D = 128, 4, 1, 256
    q, k, v = _rand(11, 1, S, H, D), _rand(12, 1, S, KV, D), _rand(13, 1, S, KV, D)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    o_ref = np.asarray(ref.flash_attention_ref(jq, jk, jv, causal=True,
                                               window=window))
    o_pal = np.asarray(flash_attention_pallas(jq, jk, jv, causal=True,
                                              window=window, interpret=True))
    o_plain = flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                    causal=True, window=window).numpy()
    np.testing.assert_allclose(o_plain, o_ref, rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(o_plain, o_pal, rtol=2e-6, atol=2e-6)


def test_flash_attention_fully_masked_rows_are_zero():
    """More queries than keys: the first Sq - Sk end-aligned queries sit
    before position 0 and see no key.  Those rows are zeros (where the
    JAX oracle's softmax averages every value row); the other rows match
    the oracle."""
    q, k, v = _rand(1, 1, 12, 2, 8), _rand(2, 1, 8, 1, 8), _rand(3, 1, 8, 1, 8)
    out = flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                causal=True).numpy()
    assert np.all(out[:, :4] == 0.0)
    o_ref = np.asarray(ref.flash_attention_ref(
        *(jnp.asarray(a) for a in (q, k, v)), causal=True))
    np.testing.assert_allclose(out[:, 4:], o_ref[:, 4:], rtol=2e-6, atol=2e-6)
    assert not np.allclose(o_ref[:, :4], 0.0)


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


def test_new_cuda_wrappers_refuse_cpu_tensors():
    """Likewise the window and flash wrappers, and the dispatch sends a
    CUDA-less CPU call to neither."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.paged_attention import paged_attention_window_cuda
    kp = torch.zeros((2, PAGE, 1, 8))
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_window_cuda(
            torch.zeros((1, 2, 2, 8)), kp, kp,
            torch.zeros((1, 1), dtype=torch.int32),
            torch.full((1,), 2, dtype=torch.int32))
    x = torch.zeros((1, 4, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(x, x[:, :, :1], x[:, :, :1])
    ops.reset_launch_counts()
    ops.flash_attention(x, x[:, :, :1], x[:, :, :1])
    ops.paged_attention(torch.zeros((1, 2, 2, 8)), kp, kp,
                        torch.zeros((1, 1), dtype=torch.int32),
                        torch.full((1,), 2, dtype=torch.int32))
    assert ops.launch_counts() == {"paged_attention": 0, "paged_window": 0,
                                   "quant_matmul": 0, "flash_attention": 0,
                                   "quantize_rowwise": 0}
