"""The port's ring-paged serving of sliding-window stacks against the JAX
package's, on the CPU.

Fixture: Gemma3-1B scaled to 2 layers, width 64, vocab 128, with its
sliding window cut to 8 tokens.  Both layers are ``attn_local``, so the
stack is uniformly sliding and ``paged_cache.ring_window`` puts every
slot on a ring block table of ``ring_pages(8, page, spec_k)`` entries
(the setup of the JAX package's ring tests, on the Gemma3 family this
repo's edge models name).  Weights come from ``repro.models.lm.init``,
bridged into the port so both packages hold the same bytes, and both
engines run with ``debug_invariants=True``: the allocator, the ring
bound (no slot above ``ring_pages`` entries) and the refcounts of
released shared pages are checked after every step on both sides.

Engine runs are compared token for token and stat for stat: the ring's
streams run many laps past the window, and the JAX package's own ring
tests hold its ring engine to the mask-only engine exactly.  Model steps
from one bridged ring cache state are compared with
``tests/tolerance.assert_close_logits`` at the bands of
``test_torch_model.py`` (the default band for fp32 pools; atol 2e-4
int8 and 2e-3 int4 for one possible code flip of a cached K/V row).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import lm as jlm
from repro.serve import paged_cache as jpc
from repro.serve import scheduler as jsched
from repro.serve.backend import SingleDeviceBackend as JaxBackend
from repro_torch import bridge
from repro_torch.models import lm as tlm
from repro_torch.serve import paged_cache as tpc
from repro_torch.serve import scheduler as tsched
from repro_torch.serve.backend import SingleDeviceBackend
from tolerance import assert_close_logits

ATOL = {"fp32": 1e-5, "int8": 2e-4, "int4": 2e-3}
WINDOW = 8


@pytest.fixture(scope="module")
def fixture():
    spec = JAX_ARCHS["gemma3-1b"].scaled_down(
        layers=2, width=64, vocab=128).with_(sliding_window=WINDOW)
    assert set(spec.layer_kinds()) == {"attn_local"}
    jp = jlm.init(jax.random.PRNGKey(0), spec)
    tp = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return spec, jp, tp


def _engines(spec, jp, tp, kw):
    jcfg = jsched.SchedulerConfig(debug_invariants=True, **kw)
    tcfg = tsched.SchedulerConfig(debug_invariants=True, **kw)
    jeng = jsched.ContinuousBatchingEngine(jp, spec, jcfg)
    teng = tsched.ContinuousBatchingEngine(
        None, spec, tcfg, backend=SingleDeviceBackend(tp, spec, tcfg,
                                                      device="cpu"))
    return jeng, teng


def _run(eng, mod, reqs, **req_kw):
    done = eng.run([mod.Request(i, p.copy(), n, **req_kw)
                    for i, (p, n) in enumerate(reqs)])
    eng.alloc.check()
    assert all(c.status == "ok" for c in done)
    return sorted(done, key=lambda c: c.uid)


def _assert_same(jdone, tdone, jeng, teng):
    for a, b in zip(jdone, tdone):
        assert a.uid == b.uid
        np.testing.assert_array_equal(b.tokens, a.tokens, err_msg=f"uid {a.uid}")
    assert dict(teng.stats) == dict(jeng.stats)


def _stream_requests(seed=4, n=6):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, 128, size=int(rng.integers(5, 14))).astype(np.int32),
             int(rng.integers(18, 30))) for _ in range(n)]


@pytest.mark.parametrize("cache_dtype", ["fp32", "int8", "int4"])
@pytest.mark.parametrize("spec_k", [1, 3])
def test_ring_engine_matches_jax(fixture, spec_k, cache_dtype):
    """Streams of 18-29 tokens past 5-13-token prompts, many laps of an
    8-token window: the port's ring engine emits the JAX ring engine's
    tokens with equal stats (recycled pages, verify windows), one ring
    of ``ring_pages`` entries per slot."""
    spec, jp, tp = fixture
    kw = dict(max_slots=3, page_size=4, max_seq=48, num_pages=40,
              spec_k=spec_k, cache_dtype=cache_dtype)
    jeng, teng = _engines(spec, jp, tp, kw)
    reqs = _stream_requests()
    jdone, tdone = _run(jeng, jsched, reqs), _run(teng, tsched, reqs)
    assert teng.ring and teng.window == WINDOW
    R = tpc.ring_pages(WINDOW, 4, spec_k)
    assert R == jpc.ring_pages(WINDOW, 4, spec_k)
    assert teng.layout.slots_pages(48) == R == jeng.layout.slots_pages(48)
    assert tuple(teng.backend.cache["block_tables"].shape) == (3, R)
    assert teng.stats["ring_recycled_pages"] > 0
    if spec_k > 1:
        assert teng.stats["spec_steps"] > 0
    _assert_same(jdone, tdone, jeng, teng)


@pytest.mark.parametrize("spec_k", [1, 3])
def test_ring_engine_matches_mask_only(fixture, spec_k):
    """The port's ring engine against its own mask-only engine
    (``windowed_kv=False``: the same windowed attention over flat tables
    that never recycle): token-identical."""
    spec, _, tp = fixture
    reqs = _stream_requests(seed=5)
    out = {}
    for wkv in (None, False):
        cfg = tsched.SchedulerConfig(max_slots=3, page_size=4, max_seq=48,
                                     num_pages=40, spec_k=spec_k,
                                     windowed_kv=wkv, debug_invariants=True)
        eng = tsched.ContinuousBatchingEngine(
            None, spec, cfg, backend=SingleDeviceBackend(tp, spec, cfg,
                                                         device="cpu"))
        out[wkv] = (eng, _run(eng, tsched, reqs))
    ring, flat = out[None], out[False]
    assert ring[0].ring and not flat[0].ring and flat[0].window == 0
    assert ring[0].stats["ring_recycled_pages"] > 0
    assert flat[0].stats["ring_recycled_pages"] == 0
    for a, b in zip(ring[1], flat[1]):
        np.testing.assert_array_equal(a.tokens, b.tokens)


def _template_requests():
    rng = np.random.default_rng(9)
    tmpl = rng.integers(1, 128, size=9).astype(np.int32)
    reqs = []
    for _ in range(5):
        suf = rng.integers(1, 128, size=int(rng.integers(2, 6))).astype(np.int32)
        reqs.append((np.concatenate([tmpl, suf]), 20))
    return reqs


@pytest.mark.parametrize("cache_dtype", ["fp32", "int8", "int4"])
def test_ring_engine_under_pressure_matches_jax(fixture, cache_dtype):
    """``windowed_kv=True`` with a pool too small for the mask-only
    layout and a shared 9-token template: prefix pages shared across
    slots fall out of the window and are RELEASED (refcount dropped, not
    freed), slots are preempted and recomputed; the port's engine runs
    the JAX engine's schedule and emits its tokens."""
    spec, jp, tp = fixture
    kw = dict(max_slots=3, page_size=4, max_seq=40, num_pages=8,
              windowed_kv=True, cache_dtype=cache_dtype)
    jeng, teng = _engines(spec, jp, tp, kw)
    reqs = _template_requests()
    jdone, tdone = _run(jeng, jsched, reqs), _run(teng, tsched, reqs)
    st = teng.stats
    assert st["ring_recycled_pages"] > 0 and st["ring_shared_released"] > 0
    assert st["preemptions"] > 0 and st["prefix_hit_tokens"] > 0
    _assert_same(jdone, tdone, jeng, teng)
    if teng.prefix_cache is not None:
        teng.prefix_cache.flush()
    teng.alloc.check()
    assert teng.alloc.free_pages == teng.layout.num_pages - 1


def test_ring_session_rejoin_past_window(fixture):
    """A session turn whose ring has wrapped by the time the next turn
    arrives: the rejoin suffix-prefills only the new tokens over the
    ring; the transcript equals the JAX engine's and a fresh ring
    engine's cold prefill of the whole history."""
    spec, jp, tp = fixture
    rng = np.random.default_rng(6)
    p1 = rng.integers(1, 128, size=7).astype(np.int32)
    extra = rng.integers(1, 128, size=5).astype(np.int32)
    kw = dict(max_slots=2, page_size=4, max_seq=64, num_pages=24,
              windowed_kv=True)
    turns = {}
    for mod, eng in zip((jsched, tsched), _engines(spec, jp, tp, kw)):
        t1 = eng.run([mod.Request(0, p1.copy(), 12, session=3)])[0]
        p2 = np.concatenate([p1, t1.tokens, extra])
        t2 = eng.run([mod.Request(1, p2.copy(), 10, session=3)])[0]
        assert eng.stats["session_reuses"] == 1
        eng.end_session(3)
        eng.alloc.check()
        turns[mod] = (t1.tokens, p2, t2.tokens, dict(eng.stats))
    (j1, jp2, j2, jst), (t1, tp2, t2, tst) = turns[jsched], turns[tsched]
    np.testing.assert_array_equal(t1, j1)
    np.testing.assert_array_equal(t2, j2)
    assert tst == jst
    cfg = tsched.SchedulerConfig(debug_invariants=True, **kw)
    fresh = tsched.ContinuousBatchingEngine(
        None, spec, cfg, backend=SingleDeviceBackend(tp, spec, cfg, device="cpu"))
    ref2 = fresh.run([tsched.Request(1, tp2.copy(), 10)])[0]
    np.testing.assert_array_equal(t2, ref2.tokens)


@pytest.mark.parametrize("cache_dtype", ["fp32", "int8", "int4"])
def test_ring_session_parked_and_swapped_in_matches_jax(fixture, cache_dtype):
    """A session slot whose ring has wrapped is parked to the host pool
    (its ring pages gathered in entry order) while unrelated traffic
    runs, then swapped back into fresh pages for the next turn: the
    port runs the JAX engine's schedule (swap-outs and swap-ins counted
    alike) and emits its tokens."""
    spec, jp, tp = fixture
    rng = np.random.default_rng(11)
    p1 = rng.integers(1, 128, size=9).astype(np.int32)
    others = [(rng.integers(1, 128, size=10).astype(np.int32), 6)
              for _ in range(3)]
    extra = rng.integers(1, 128, size=4).astype(np.int32)
    kw = dict(max_slots=2, page_size=4, max_seq=64, num_pages=24,
              windowed_kv=True, cache_dtype=cache_dtype, host_pool_bytes=50e6,
              idle_park_iterations=2)
    res = {}
    for mod, eng in zip((jsched, tsched), _engines(spec, jp, tp, kw)):
        t1 = eng.run([mod.Request(0, p1.copy(), 14, session=7)])[0]
        eng.run([mod.Request(100 + i, p.copy(), n)
                 for i, (p, n) in enumerate(others)])
        assert eng.stats["idle_parks"] == 1 and eng.num_parked == 1
        p2 = np.concatenate([p1, t1.tokens, extra])
        t2 = eng.run([mod.Request(1, p2.copy(), 10, session=7)])[0]
        assert eng.stats["swap_ins"] == 1
        eng.end_session(7)
        eng.alloc.check()
        res[mod] = (t1.tokens, t2.tokens, dict(eng.stats))
    for a, b in zip(res[jsched], res[tsched]):
        if isinstance(a, dict):
            assert b == a
        else:
            np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("cache_dtype", ["fp32", "int8", "int4"])
def test_wrapped_ring_swap_round_trip_byte_identical(fixture, cache_dtype):
    """Swap is page-level: a slot admitted with a prompt longer than its
    ring (the admission keeps only the last R pages, so the ring has
    wrapped) and decoded a few steps gathers its R pages to the host;
    scattered into other pages and gathered again, the bytes are equal,
    and decoding on from the swapped-in pages (same ring order) gives
    the logits of decoding on from the original ones."""
    spec, _, tp = fixture
    cfg = tsched.SchedulerConfig(max_slots=3, page_size=4, max_seq=64,
                                 num_pages=10, cache_dtype=cache_dtype)
    be = SingleDeviceBackend(tp, spec, cfg, device="cpu")
    assert be.ring and be.layout.num_pages == 10
    R = tpc.ring_pages(WINDOW, 4)
    prompt = np.zeros((1, 32), np.int32)
    prompt[0, :21] = np.random.default_rng(3).integers(1, 128, size=21)
    row = np.asarray([2, 5, 7], np.int32)
    assert row.shape == (R,)
    tok = be.admit_full(prompt, 0, 21, row)
    for _ in range(2):                  # positions 21, 22: page 5 -> entry 2
        out, _, _ = be.decode(np.asarray([[tok]] * 3, np.int32),
                              np.asarray([1, 0, 0], np.int32))
        tok = int(out[0, 0])
    blob = be.swap_out(row.tolist())
    be.swap_in(blob, [8, 9, 3])
    again = be.swap_out([8, 9, 3])
    for g, ag in zip(blob, again):
        for e, ae in zip(g, ag):
            for name in e:
                np.testing.assert_array_equal(e[name], ae[name])
    tokens = torch.tensor([[tok]] * 3)
    swapped = be.cache["block_tables"].clone()
    swapped[0] = torch.tensor([8, 9, 3])
    logits = []
    for bt in (be.cache["block_tables"], swapped):
        cache = {"pos": be.cache["pos"].clone(), "block_tables": bt.clone(),
                 "groups": be.cache["groups"]}
        l, _ = tlm.decode_step_paged(be.params, spec, cache, tokens, ring=True)
        logits.append(l[0])
    l1, l2 = logits
    torch.testing.assert_close(l2, l1, rtol=0, atol=0)


def test_mixed_local_global_gemma3_engine_matches_jax():
    """Gemma3 with a global layer (6 layers, 5 local then 1 global) is
    not uniformly sliding: both packages serve it on FLAT tables, the
    local layers masking their window, over prompts longer than the
    window."""
    spec = JAX_ARCHS["gemma3-1b"].scaled_down(
        layers=6, width=64, vocab=128).with_(sliding_window=WINDOW)
    assert list(spec.layer_kinds()).count("attn_global") == 1
    jp = jlm.init(jax.random.PRNGKey(1), spec)
    tp = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(12)
    reqs = [(rng.integers(1, 128, size=int(n)).astype(np.int32), 12)
            for n in (11, 19, 26, 14)]
    kw = dict(max_slots=3, page_size=4, max_seq=48, num_pages=40,
              cache_dtype="int8")
    jeng, teng = _engines(spec, jp, tp, kw)
    jdone, tdone = _run(jeng, jsched, reqs), _run(teng, tsched, reqs)
    assert not teng.ring and teng.window == 0
    _assert_same(jdone, tdone, jeng, teng)


# ---------------------------------------------------------------------------
# Model steps over one bridged ring cache
# ---------------------------------------------------------------------------

def _ring_state(spec, jp, cache_dtype):
    """A JAX ring cache (R = ring_pages(8, 4, 3) = 4 entries per slot):
    slot 0 admitted with a 21-token prompt (8 prompt pages, only the
    last four kept: the ring has wrapped), slot 1 with a 6-token one
    (ring still filling); and the port's copy of it."""
    cfg = jsched.SchedulerConfig(max_slots=2, page_size=4, max_seq=64,
                                 num_pages=12, cache_dtype=cache_dtype,
                                 spec_k=3)
    be = JaxBackend(jp, spec, cfg)
    assert be.ring and be.cache["block_tables"].shape == (2, 4)
    rng = np.random.default_rng(13)
    p0 = np.zeros((1, 32), np.int32)
    p0[0, :21] = rng.integers(1, 128, size=21)
    p1 = np.zeros((1, 8), np.int32)
    p1[0, :6] = rng.integers(1, 128, size=6)
    be.admit_full(p0, 0, 21, np.asarray([1, 2, 3, 4], np.int32))
    be.admit_full(p1, 1, 6, np.asarray([5, 6, 7, 8], np.int32))
    jc = jax.tree_util.tree_map(np.asarray, be.cache)
    return jax.tree_util.tree_map(jnp.asarray, jc), bridge.cache_from_jax(jc, "cpu")


@pytest.mark.parametrize("cache_dtype", ["fp32", "int8", "int4"])
def test_ring_admission_matches_jax(fixture, cache_dtype):
    """The port's ring admission (prompt pages to entries ``q % R`` in
    the final horizon, the rest to the null page) fills the same pages
    as the JAX one: equal bytes for quantized pools where both quantize
    the same rows, and fp32 pools within the prefill band."""
    spec, jp, tp = fixture
    jc, _ = _ring_state(spec, jp, cache_dtype)
    cfg = tsched.SchedulerConfig(max_slots=2, page_size=4, max_seq=64,
                                 num_pages=12, cache_dtype=cache_dtype,
                                 spec_k=3)
    be = SingleDeviceBackend(tp, spec, cfg, device="cpu")
    rng = np.random.default_rng(13)
    p0 = np.zeros((1, 32), np.int32)
    p0[0, :21] = rng.integers(1, 128, size=21)
    p1 = np.zeros((1, 8), np.int32)
    p1[0, :6] = rng.integers(1, 128, size=6)
    be.admit_full(p0, 0, 21, np.asarray([1, 2, 3, 4], np.int32))
    be.admit_full(p1, 1, 6, np.asarray([5, 6, 7, 8], np.int32))
    np.testing.assert_array_equal(be.cache["pos"].numpy(), np.asarray(jc["pos"]))
    np.testing.assert_array_equal(be.cache["block_tables"].numpy(),
                                  np.asarray(jc["block_tables"]))
    for jg, tg in zip(jc["groups"], be.cache["groups"]):
        for je, te in zip(jg, tg):
            for name in je:
                a, b = np.asarray(je[name])[1:], te[name].numpy()[1:]
                if a.dtype == np.int8:     # a code may round the other way
                    assert np.abs(a.astype(np.int32) - b).max() <= 1, name
                else:
                    np.testing.assert_allclose(b, a, rtol=2e-5, atol=2e-6,
                                               err_msg=name)


@pytest.mark.parametrize("cache_dtype", ["fp32", "int8", "int4"])
def test_ring_decode_steps_match_jax(fixture, cache_dtype):
    """Three ring decode steps from one bridged state (slot 0 wrapped,
    slot 1 filling; writes go to entry ``pos // page % R``) and then a
    K=3 ring verify window with ragged lens: logits within the band."""
    spec, jp, tp = fixture
    jc, tc = _ring_state(spec, jp, cache_dtype)
    atol = ATOL[cache_dtype]
    tok = np.asarray([[7], [9]], np.int32)
    for step in range(3):
        jl, jc = jlm.decode_step_paged(jp, spec, jc, jnp.asarray(tok), ring=True)
        tl, tc = tlm.decode_step_paged(tp, spec, tc, torch.from_numpy(tok),
                                       ring=True)
        assert_close_logits(tl.numpy(), np.asarray(jl), atol=atol,
                            context=f"ring decode step {step}")
        tok = np.asarray(jnp.argmax(jl[:, 0], -1), np.int32)[:, None]
    np.testing.assert_array_equal(tc["pos"].numpy(), [24, 9])
    window = np.asarray([[int(tok[0, 0]), 3, 9], [int(tok[1, 0]), 120, 0]],
                        np.int32)
    lens = np.asarray([3, 2], np.int32)
    jl, _ = jlm.decode_window_paged(jp, spec, jc, jnp.asarray(window),
                                    jnp.asarray(lens), ring=True)
    tl, tc = tlm.decode_window_paged(tp, spec, tc, torch.from_numpy(window),
                                     torch.from_numpy(lens), ring=True)
    assert_close_logits(tl.numpy(), np.asarray(jl), atol=atol,
                        context="ring verify window")
    np.testing.assert_array_equal(tc["pos"].numpy(), [24, 9])


@pytest.mark.parametrize("true_len", [5, 20])
@pytest.mark.parametrize("cache_dtype", ["fp32", "int8", "int4"])
def test_ring_suffix_prefill_matches_jax(fixture, cache_dtype, true_len):
    """A suffix prefill onto slot 0's wrapped ring (prefix 21 tokens):
    the prefix gather maps each entry to its absolute positions.  A
    5-token suffix lands on entries 1 and 2; a 20-token chunk spans six
    pages, of which only the last R = 4 are kept (the two before the
    horizon go to the null page).  Logits within the band, then one ring
    decode step from both states."""
    spec, jp, tp = fixture
    jc, tc = _ring_state(spec, jp, cache_dtype)
    atol = ATOL[cache_dtype]
    bucket = 8 if true_len <= 8 else 32
    suffix = np.zeros((1, bucket), np.int32)
    suffix[0, :true_len] = np.random.default_rng(14).integers(1, 128,
                                                             size=true_len)
    row = np.asarray([1, 2, 3, 4], np.int32)
    jl, jc = jlm.prefill_paged(jp, spec, jnp.asarray(suffix), jc, 0,
                               jnp.asarray(row), 21, true_len,
                               n_prefix_pages=4, ring=True)
    tl, tc = tlm.prefill_paged(tp, spec, torch.from_numpy(suffix), tc, 0,
                               torch.from_numpy(row), 21, true_len,
                               n_prefix_pages=4, ring=True)
    assert_close_logits(tl.numpy(), np.asarray(jl), atol=atol,
                        context="ring suffix prefill")
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    tok = np.asarray([[5], [6]], np.int32)
    jl, _ = jlm.decode_step_paged(jp, spec, jc, jnp.asarray(tok), ring=True)
    tl, _ = tlm.decode_step_paged(tp, spec, tc, torch.from_numpy(tok), ring=True)
    assert_close_logits(tl.numpy(), np.asarray(jl), atol=atol,
                        context="decode after ring suffix prefill")
