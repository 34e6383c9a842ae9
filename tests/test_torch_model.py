"""The port's model (``repro_torch.models.lm``) against the JAX package's
on the serve fixture: granite-3-8b scaled to 2 layers, width 64.

Weights are made once by ``repro.models.lm.init`` (and
``quantize_params`` for int8/int4), turned into numpy and handed to the
port through ``repro_torch.bridge``, so both sides hold the same bytes.
Both packages then run the same sequence on their own page pools: cold
prefill scattered into pages, a prefix-hit suffix prefill, and decode
steps fed the same tokens; speculative verify windows and the
flash-attention prefill start from one state.  Pool writes are compared byte for byte
where both sides quantize the same float rows; elsewhere the rows each
side computes differ in the last bits, so an int8/int4 code can round
the other way, and logits are compared within a band.

Tolerances on logits (``tests/tolerance.assert_close_logits``):

* fp32 pools: rtol 2e-5, atol 1e-5 (the module's default band): only
  f32 summation order differs between XLA and PyTorch;
* int8 / int4 pools: the same band plus a rounding flip of one cached
  K/V code, at most one quantization step (amax/127 or amax/7 of one
  row) through two layers: atol 2e-4 (int8) and 2e-3 (int4) on logits
  whose scale is about 0.3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED
from repro.models import lm as jlm
from repro.quant.qlinear import quantize_params as jax_quantize_params
from repro.serve import paged_cache as jpc
from repro_torch import bridge
from repro_torch.models import lm as tlm
from repro_torch.quant.qtypes import QuantizedTensor
from repro_torch.serve import paged_cache as tpc
from tolerance import assert_close_logits

ATOL = {"fp32": 1e-5, "int8": 2e-4, "int4": 2e-3}
PAGE, NUM_PAGES, SLOTS, MAX_SEQ = 8, 17, 2, 64


@pytest.fixture(scope="module")
def fixture():
    spec = ASSIGNED["granite-3-8b"].scaled_down(layers=2, width=64, vocab=128)
    base = jlm.init(jax.random.PRNGKey(0), spec)
    out = {}
    for prec in ("fp32", "int8", "int4"):
        jp = base if prec == "fp32" else jax_quantize_params(base, prec)
        jp = jax.tree_util.tree_map(np.asarray, jp)
        out[prec] = (jp, bridge.params_from_jax(jp, "cpu"))
    return spec, out


def _leaves_equal(a, b):
    if isinstance(a, dict) and set(a) == {"q", "scale", "zero"}:
        np.testing.assert_array_equal(a["q"], np.asarray(b.q))
        np.testing.assert_array_equal(a["scale"], np.asarray(b.scale))
        assert (a["zero"] is None) == (b.zero is None)
        return
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _leaves_equal(a[k], b[k])
        return
    if isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _leaves_equal(x, y)
        return
    np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("prec", ["fp32", "int8", "int4"])
def test_bridge_round_trip(fixture, prec):
    spec, params = fixture
    jp, tp = params[prec]
    _leaves_equal(bridge.params_to_numpy(tp), jp)
    # stacked (L, ...) leaves became per-layer tensors / QuantizedTensors
    assert len(tp["groups"][0]) == spec.num_layers
    w = tp["groups"][0][0]["wq"]
    if prec == "fp32":
        assert isinstance(w, torch.Tensor) and w.shape == (64, spec.q_dim)
    else:
        assert isinstance(w, QuantizedTensor) and w.shape == (64, spec.q_dim)
        assert w.config.bits == (8 if prec == "int8" else 4)
    assert not isinstance(tp["global"]["embed"], QuantizedTensor)


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, 128, size=n).astype(np.int32)


@pytest.mark.parametrize("prec", ["fp32", "int8", "int4"])
def test_prefill_logits_match_jax(fixture, prec):
    spec, params = fixture
    jp, tp = params[prec]
    prompt = np.zeros((1, 16), np.int32)
    prompt[0, :13] = _prompt(1, 13)
    jl, jc = jlm.prefill(jp, spec, {"tokens": jnp.asarray(prompt)},
                         max_seq=16, impl="naive", true_len=13)
    tl, tc = tlm.prefill(tp, spec, {"tokens": torch.from_numpy(prompt)},
                         max_seq=16, true_len=13)
    assert_close_logits(tl.numpy(), np.asarray(jl), context=prec)
    assert int(tc["pos"]) == 13
    for jg, tg in zip(jc["groups"], tc["groups"]):
        for jl_, tl_ in zip(jg, tg):
            for name in ("k", "v"):
                np.testing.assert_allclose(tl_[name].numpy(),
                                           np.asarray(jl_[name]),
                                           rtol=2e-5, atol=2e-6)


def _jax_admit(spec, params, cache, slot, prompt, pages):
    bucket = 16
    padded = np.zeros((1, bucket), np.int32)
    padded[0, :len(prompt)] = prompt
    logits, pre = jlm.prefill(params, spec, {"tokens": jnp.asarray(padded)},
                              max_seq=bucket, impl="naive", true_len=len(prompt))
    row = np.zeros((cache["block_tables"].shape[1],), np.int32)
    row[:len(pages)] = pages
    pv = jnp.asarray(row[:bucket // PAGE])
    groups = jpc.scatter_prompt_pages(cache["groups"], pre["groups"], pv, PAGE)
    cache = {"pos": cache["pos"].at[slot].set(len(prompt)),
             "block_tables": cache["block_tables"].at[slot].set(jnp.asarray(row)),
             "groups": groups}
    return logits, cache


def _torch_admit(spec, params, cache, slot, prompt, pages):
    bucket = 16
    padded = np.zeros((1, bucket), np.int32)
    padded[0, :len(prompt)] = prompt
    logits, pre = tlm.prefill(params, spec, {"tokens": torch.from_numpy(padded)},
                              max_seq=bucket, true_len=len(prompt))
    row = np.zeros((cache["block_tables"].shape[1],), np.int32)
    row[:len(pages)] = pages
    tpc.scatter_prompt_pages(cache["groups"], pre["groups"],
                             torch.from_numpy(row[:bucket // PAGE]), PAGE)
    cache["pos"][slot] = len(prompt)
    cache["block_tables"][slot] = torch.from_numpy(row)
    return logits, cache


def _pools_equal(jcache, tcache):
    for jg, tg in zip(jcache["groups"], tcache["groups"]):
        for je, te in zip(jg, tg):
            assert set(je) == set(te)
            for name in je:
                np.testing.assert_array_equal(np.asarray(je[name]),
                                              te[name].numpy(), err_msg=name)


@pytest.mark.parametrize("cache_dtype", ["fp32", "int8", "int4"])
@pytest.mark.parametrize("prec", ["fp32", "int8", "int4"])
def test_paged_prefill_and_decode_match_jax(fixture, prec, cache_dtype):
    """Cold admission of slot 0, a suffix prefill of slot 1 over slot 0's
    first page (prefix hit), then three decode steps of both slots."""
    spec, params = fixture
    jp, tp = params[prec]
    layout_j = jlm.PagedLayout(num_pages=NUM_PAGES, page_size=PAGE)
    layout_t = tlm.PagedLayout(num_pages=NUM_PAGES, page_size=PAGE)
    jc = jlm.init_paged_cache(spec, SLOTS, MAX_SEQ, layout_j, cache_dtype)
    tc = tlm.init_paged_cache(spec, SLOTS, MAX_SEQ, layout_t, cache_dtype,
                              device="cpu")
    _pools_equal(jc, tc)
    atol = ATOL[cache_dtype]

    p0 = _prompt(2, 13)
    jl, jc = _jax_admit(spec, jp, jc, 0, p0, [3, 5])
    tl, tc = _torch_admit(spec, tp, tc, 0, p0, [3, 5])
    assert_close_logits(tl.numpy(), np.asarray(jl), context="admit")

    # slot 1 shares slot 0's first page (8 cached tokens) + 5-token suffix
    p1 = np.concatenate([p0[:8], _prompt(3, 5)])
    suffix = np.zeros((1, 8), np.int32)
    suffix[0, :5] = p1[8:]
    row = np.zeros((MAX_SEQ // PAGE,), np.int32)
    row[:3] = [3, 7, 9]
    jl, jc = jlm.prefill_paged(jp, spec, jnp.asarray(suffix), jc, 1,
                               jnp.asarray(row), 8, 5, n_prefix_pages=1)
    tl, tc = tlm.prefill_paged(tp, spec, torch.from_numpy(suffix), tc, 1,
                               torch.from_numpy(row), 8, 5, n_prefix_pages=1)
    assert_close_logits(tl.numpy(), np.asarray(jl), atol=atol, context="suffix")
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    np.testing.assert_array_equal(tc["block_tables"].numpy(),
                                  np.asarray(jc["block_tables"]))

    tok = np.asarray([[int(p0[-1])], [int(p1[-1])]], np.int32)
    for step in range(3):
        jl, jc = jlm.decode_step_paged(jp, spec, jc, jnp.asarray(tok))
        tl, tc = tlm.decode_step_paged(tp, spec, tc, torch.from_numpy(tok))
        assert tl.shape == (SLOTS, 1, spec.padded_vocab)
        assert_close_logits(tl.numpy(), np.asarray(jl), atol=atol,
                            context=f"decode step {step}")
        tok = np.asarray(jnp.argmax(jl[:, 0], -1), np.int32)[:, None]
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("cache_dtype", ["fp32", "int8", "int4"])
def test_decode_from_bridged_cache_matches_jax(fixture, cache_dtype):
    """One decode step from ONE cache state (the JAX cache bridged into
    the port), int4 weights."""
    spec, params = fixture
    jp, tp = params["int4"]
    layout = jlm.PagedLayout(num_pages=NUM_PAGES, page_size=PAGE)
    jc = jlm.init_paged_cache(spec, SLOTS, MAX_SEQ, layout, cache_dtype)
    _, jc = _jax_admit(spec, jp, jc, 0, _prompt(4, 11), [2, 6])
    _, jc = _jax_admit(spec, jp, jc, 1, _prompt(5, 16), [4, 8, 10])
    tc = bridge.cache_from_jax(jax.tree_util.tree_map(np.asarray, jc), "cpu")
    _pools_equal(jc, tc)
    tok = np.asarray([[7], [9]], np.int32)
    jl, _ = jlm.decode_step_paged(jp, spec, jc, jnp.asarray(tok))
    tl, _ = tlm.decode_step_paged(tp, spec, tc, torch.from_numpy(tok))
    assert_close_logits(tl.numpy(), np.asarray(jl), atol=ATOL[cache_dtype])


@pytest.mark.parametrize("cache_dtype", ["fp32", "int8", "int4"])
def test_scatter_kv_rows_bytes_equal_jax(cache_dtype):
    """Identical float rows into identical pools: the written bytes and
    scales are EQUAL.  Targets include both nibbles of one byte and a
    row whose neighbour nibble must survive (int4 read-modify-write)."""
    spec = ASSIGNED["granite-3-8b"].scaled_down(layers=1, width=64, vocab=128)
    layout = jlm.PagedLayout(num_pages=6, page_size=PAGE)
    jc = jlm.init_paged_cache(spec, 2, 32, layout, cache_dtype)
    rng = np.random.default_rng(6)
    entry = jax.tree_util.tree_map(np.asarray, jc["groups"][0][0])
    for name in entry:                       # non-zero pools to preserve
        if entry[name].dtype == np.int8:
            entry[name] = rng.integers(-128, 128, entry[name].shape).astype(np.int8)
        else:
            entry[name] = rng.normal(size=entry[name].shape).astype(np.float32)
    KV, D = spec.num_kv_heads, spec.head_dim
    rows = rng.normal(size=(5, KV, D)).astype(np.float32)
    page = np.asarray([2, 2, 3, 4, 0], np.int32)
    off = np.asarray([4, 5, 7, 0, 3], np.int32)
    jent = {k: jnp.asarray(v) for k, v in entry.items()}
    tent = {k: torch.from_numpy(v.copy()) for k, v in entry.items()}
    for name in ("k", "v"):
        jent.update(jlm._scatter_kv_rows(jent, name, jnp.asarray(rows),
                                         jnp.asarray(page), jnp.asarray(off)))
        tlm._scatter_kv_rows(tent, name, torch.from_numpy(rows),
                             torch.from_numpy(page), torch.from_numpy(off))
    for name in jent:
        a, b = np.asarray(jent[name]), tent[name].numpy()
        # page 0 is the null page: duplicate writes land there in
        # unspecified order on both sides
        np.testing.assert_array_equal(a[1:], b[1:], err_msg=name)


def _bridged_window_state(spec, jp, cache_dtype):
    """A JAX paged cache with slot 0 at an ODD position (11) and slot 1 at
    an even one (16), and the port's copy of it."""
    layout = jlm.PagedLayout(num_pages=NUM_PAGES, page_size=PAGE)
    jc = jlm.init_paged_cache(spec, SLOTS, MAX_SEQ, layout, cache_dtype)
    _, jc = _jax_admit(spec, jp, jc, 0, _prompt(4, 11), [2, 6])
    _, jc = _jax_admit(spec, jp, jc, 1, _prompt(5, 16), [4, 8, 10])
    return jc, bridge.cache_from_jax(jax.tree_util.tree_map(np.asarray, jc),
                                     "cpu")


@pytest.mark.parametrize("cache_dtype", ["fp32", "int8", "int4"])
def test_decode_window_from_bridged_cache_matches_jax(fixture, cache_dtype):
    """One K=3 verify window from ONE cache state, int4 weights, ragged
    ``lens`` (3 and 2): window rows start at an odd position in slot 0
    (int4: a high nibble, then both nibbles of the next byte) and at an
    even one in slot 1.  Logits of every window position agree within the
    band, ``pos`` stays put, and the written rows decode alike: a
    following single-token step from both caches agrees too."""
    spec, params = fixture
    jp, tp = params["int4"]
    jc, tc = _bridged_window_state(spec, jp, cache_dtype)
    tokens = np.asarray([[7, 3, 9], [9, 120, 0]], np.int32)
    lens = np.asarray([3, 2], np.int32)
    jl, jc = jlm.decode_window_paged(jp, spec, jc, jnp.asarray(tokens),
                                     jnp.asarray(lens))
    tl, tc = tlm.decode_window_paged(tp, spec, tc, torch.from_numpy(tokens),
                                     torch.from_numpy(lens))
    assert tl.shape == (SLOTS, 3, spec.padded_vocab)
    assert_close_logits(tl.numpy(), np.asarray(jl), atol=ATOL[cache_dtype],
                        context="window")
    np.testing.assert_array_equal(tc["pos"].numpy(), [11, 16])
    # commit the real rows and decode one more token from both states
    jc["pos"] = jc["pos"] + jnp.asarray(lens)
    tc["pos"] = tc["pos"] + torch.from_numpy(lens)
    nxt = np.asarray([[5], [6]], np.int32)
    jl, _ = jlm.decode_step_paged(jp, spec, jc, jnp.asarray(nxt))
    tl, _ = tlm.decode_step_paged(tp, spec, tc, torch.from_numpy(nxt))
    assert_close_logits(tl.numpy(), np.asarray(jl), atol=ATOL[cache_dtype],
                        context="decode after window")


@pytest.mark.parametrize("cache_dtype", ["fp32", "int8", "int4"])
def test_window_positions_match_sequential_decode(fixture, cache_dtype):
    """Window position j scores what j sequential ``decode_step_paged``
    calls give after committing the window's first j tokens (the
    exactness that greedy acceptance rests on): same pages, per-token
    quantization, per-position rope; only the matmul rows (M = B*K
    against M = B) differ."""
    spec, params = fixture
    jp, tp = params["int4"]
    _, seq = _bridged_window_state(spec, jp, cache_dtype)
    _, win = _bridged_window_state(spec, jp, cache_dtype)
    K = 4
    toks = [np.asarray([[7], [9]], np.int32)]
    seq_logits = []
    for _ in range(K):
        l, seq = tlm.decode_step_paged(tp, spec, seq, torch.from_numpy(toks[-1]))
        seq_logits.append(l[:, 0].numpy())
        toks.append(l[:, 0].argmax(-1).numpy().astype(np.int32)[:, None])
    window = np.concatenate(toks[:K], axis=1)
    wl, win = tlm.decode_window_paged(tp, spec, win, torch.from_numpy(window),
                                      torch.full((SLOTS,), K, dtype=torch.int32))
    for j in range(K):
        assert_close_logits(wl[:, j].numpy(), seq_logits[j],
                            atol=ATOL[cache_dtype], context=f"position {j}")
        np.testing.assert_array_equal(wl[:, j].argmax(-1).numpy(),
                                      seq_logits[j].argmax(-1))
    np.testing.assert_array_equal(win["pos"].numpy(), [11, 16])
    np.testing.assert_array_equal(seq["pos"].numpy(), [11 + K, 16 + K])


@pytest.mark.parametrize("prec", ["fp32", "int4"])
def test_prefill_pallas_logits_match_jax(fixture, prec):
    """``prefill(impl="pallas")`` (the flash attention op) against the
    JAX function on a bucket-padded 128-token prompt of 97 real tokens,
    and against the port's own ``sdpa`` prefill."""
    spec, params = fixture
    jp, tp = params[prec]
    prompt = np.zeros((1, 128), np.int32)
    prompt[0, :97] = _prompt(8, 97)
    jl, jc = jlm.prefill(jp, spec, {"tokens": jnp.asarray(prompt)},
                         max_seq=128, impl="pallas", true_len=97)
    tl, tc = tlm.prefill(tp, spec, {"tokens": torch.from_numpy(prompt)},
                         max_seq=128, impl="pallas", true_len=97)
    assert_close_logits(tl.numpy(), np.asarray(jl), context=prec)
    nl, _ = tlm.prefill(tp, spec, {"tokens": torch.from_numpy(prompt)},
                        max_seq=128, true_len=97)
    assert_close_logits(tl.numpy(), nl.numpy(), context="flash vs sdpa")
    for jg, tg in zip(jc["groups"], tc["groups"]):
        for jl_, tl_ in zip(jg, tg):
            for name in ("k", "v"):
                np.testing.assert_allclose(tl_[name].numpy(),
                                           np.asarray(jl_[name]),
                                           rtol=2e-5, atol=2e-6)


@pytest.fixture(scope="module")
def gemma3():
    """Gemma3-1B scaled to 6 layers (5 local, 1 global), window 8, head
    dim 32 against d_model / H = 16 (as 256 against 1152 / 4 at full
    width), one KV head, tied embeddings and the sqrt(d_model) embedding
    scale."""
    from repro.configs import ARCHS as JAX_ARCHS
    spec = JAX_ARCHS["gemma3-1b"].scaled_down(
        layers=6, width=64, vocab=128).with_(sliding_window=8, head_dim=32)
    assert spec.head_dim * spec.num_heads != spec.d_model
    assert spec.num_kv_heads == 1 and spec.tie_embeddings
    base = jlm.init(jax.random.PRNGKey(3), spec)
    out = {}
    for prec in ("fp32", "int4"):
        jp = base if prec == "fp32" else jax_quantize_params(base, prec)
        jp = jax.tree_util.tree_map(np.asarray, jp)
        out[prec] = (jp, bridge.params_from_jax(jp, "cpu"))
    return spec, out


@pytest.mark.parametrize("cache_dtype", ["fp32", "int8", "int4"])
@pytest.mark.parametrize("prec", ["fp32", "int4"])
def test_gemma3_paged_steps_match_jax(gemma3, prec, cache_dtype):
    """The Gemma3 family on flat tables: a 13-token cold admission (past
    the 8-token window, so the local layers mask), three decode steps and
    a K=3 verify window from the same states, both slots: logits within
    the bands of this module."""
    spec, params = gemma3
    jp, tp = params[prec]
    layout_j = jlm.PagedLayout(num_pages=NUM_PAGES, page_size=PAGE)
    layout_t = tlm.PagedLayout(num_pages=NUM_PAGES, page_size=PAGE)
    jc = jlm.init_paged_cache(spec, SLOTS, MAX_SEQ, layout_j, cache_dtype)
    tc = tlm.init_paged_cache(spec, SLOTS, MAX_SEQ, layout_t, cache_dtype,
                              device="cpu")
    atol = ATOL[cache_dtype]
    for slot, (seed, n, pages) in enumerate([(9, 13, [3, 5]), (10, 16, [2, 4])]):
        p = _prompt(seed, n)
        jl, jc = _jax_admit(spec, jp, jc, slot, p, pages)
        tl, tc = _torch_admit(spec, tp, tc, slot, p, pages)
        assert_close_logits(tl.numpy(), np.asarray(jl), context=f"admit {slot}")
    jc["block_tables"] = jc["block_tables"].at[:, 2].set(jnp.asarray([7, 8]))
    tc["block_tables"][:, 2] = torch.tensor([7, 8])
    tok = np.asarray([[11], [12]], np.int32)
    for step in range(3):
        jl, jc = jlm.decode_step_paged(jp, spec, jc, jnp.asarray(tok))
        tl, tc = tlm.decode_step_paged(tp, spec, tc, torch.from_numpy(tok))
        assert_close_logits(tl.numpy(), np.asarray(jl), atol=atol,
                            context=f"decode step {step}")
        tok = np.asarray(jnp.argmax(jl[:, 0], -1), np.int32)[:, None]
    window = np.concatenate([tok, np.asarray([[3, 9], [120, 0]], np.int32)], 1)
    lens = np.asarray([3, 2], np.int32)
    jl, _ = jlm.decode_window_paged(jp, spec, jc, jnp.asarray(window),
                                    jnp.asarray(lens))
    tl, _ = tlm.decode_window_paged(tp, spec, tc, torch.from_numpy(window),
                                    torch.from_numpy(lens))
    assert_close_logits(tl.numpy(), np.asarray(jl), atol=atol, context="window")
