"""The port's continuous-batching engine against the JAX package's.

Both engines run the same requests on the serve fixture (granite-3-8b
scaled to 2 layers, width 64) with the same weights (bridged from
``repro.models.lm.init``) and ``debug_invariants=True``, so allocator,
host-pool and slot invariants are checked after every step on both
sides.  The workloads drive prefix sharing with copy-on-write,
preemption under a tiny pool, chunked prefill and the host swap tier.

Greedy streams are compared with ``assert_close_tokens`` (matching
prefix >= 0.9 of the stream): the two frameworks' logits differ in the
last float bits, and greedy decoding can turn a near-tie into a
different token.  Where the streams are identical the host-side
scheduler ran the same schedule, so its ``stats`` must be equal too.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED
from repro.models import lm as jlm
from repro.quant.qlinear import quantize_params as jax_quantize_params
from repro.serve import scheduler as jsched
from repro.serve.backend import SingleDeviceBackend as JaxBackend
from repro_torch import bridge
from repro_torch.configs import ARCHS
from repro_torch.serve import scheduler as tsched
from repro_torch.serve.backend import SingleDeviceBackend
from tolerance import assert_close_tokens


@pytest.fixture(scope="module")
def fixture():
    spec = ASSIGNED["granite-3-8b"].scaled_down(layers=2, width=64, vocab=128)
    base = jlm.init(jax.random.PRNGKey(0), spec)
    out = {}
    for prec in ("fp32", "int4"):
        jp = base if prec == "fp32" else jax_quantize_params(base, prec)
        out[prec] = (jp, bridge.params_from_jax(
            jax.tree_util.tree_map(np.asarray, jp), "cpu"))
    return spec, out


def _requests(kind: str):
    rng = np.random.default_rng({"prefix": 1, "chunk": 2, "swap": 3}[kind])
    if kind == "prefix":
        # request 0 is a 12-token template ending mid-page (page 8);
        # the others extend it, so they share its full page and
        # copy-on-write the partial one
        tmpl = rng.integers(1, 128, size=12).astype(np.int32)
        return [(tmpl, 10)] + [
            (np.concatenate([tmpl, rng.integers(1, 128, size=int(n))
                             .astype(np.int32)]), 10)
            for n in rng.integers(3, 9, size=5)]
    if kind == "chunk":
        return [(rng.integers(1, 128, size=int(n)).astype(np.int32), 6)
                for n in (40, 9, 33, 21)]
    return [(rng.integers(1, 128, size=int(n)).astype(np.int32), 16)
            for n in rng.integers(12, 28, size=5)]


CONFIGS = {
    # name: (requests, precision, SchedulerConfig kwargs)
    "prefix_cow_preempt": ("prefix", "fp32", dict(
        max_slots=3, page_size=8, max_seq=64, num_pages=9,
        cache_dtype="int8")),
    "chunked_prefill": ("chunk", "int4", dict(
        max_slots=3, page_size=8, max_seq=80, num_pages=40,
        cache_dtype="int4", prefill_chunk_tokens=16)),
    "host_swap": ("swap", "fp32", dict(
        max_slots=3, page_size=8, max_seq=64, num_pages=12,
        cache_dtype="int4", host_pool_bytes=50e6)),
    "host_swap_fp32_pages": ("swap", "int4", dict(
        max_slots=3, page_size=8, max_seq=64, num_pages=12,
        cache_dtype="fp32", host_pool_bytes=50e6)),
}


def _run(mod, params, spec, kw, reqs, backend=None):
    cfg = mod.SchedulerConfig(debug_invariants=True, **kw)
    eng = mod.ContinuousBatchingEngine(params, spec, cfg, backend=backend)
    done = eng.run([mod.Request(i, p.copy(), n) for i, (p, n) in enumerate(reqs)])
    eng.alloc.check()
    assert all(c.status == "ok" for c in done)
    return eng, sorted(done, key=lambda c: c.uid)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_engine_matches_jax(fixture, name):
    kind, prec, kw = CONFIGS[name]
    spec, params = fixture
    jp, tp = params[prec]
    reqs = _requests(kind)
    jeng, jdone = _run(jsched, jp, spec, kw, reqs)
    tcfg = tsched.SchedulerConfig(debug_invariants=True, **kw)
    teng, tdone = _run(tsched, None, spec, kw, reqs,
                       backend=SingleDeviceBackend(tp, spec, tcfg, device="cpu"))
    identical = True
    for a, b in zip(jdone, tdone):
        assert a.uid == b.uid and len(a.tokens) == len(b.tokens)
        assert_close_tokens(b.tokens, a.tokens, context=f"{name} uid {a.uid}")
        identical &= bool(np.array_equal(a.tokens, b.tokens))
    if identical:
        assert dict(teng.stats) == dict(jeng.stats)
    st = teng.stats
    if kind == "prefix":
        assert st["prefix_hit_tokens"] > 0 and st["cow_copies"] > 0
        assert st["preemptions"] > 0, "pool sized to force preemption"
    elif kind == "chunk":
        assert st["prefill_chunks"] > 0
    else:
        assert st["swap_outs"] > 0 and st["swap_ins"] == st["swap_outs"]
        assert len(teng.host_pool) == 0 and teng.host_pool.used_bytes == 0


@pytest.mark.parametrize("cache_dtype", ["fp32", "int8", "int4"])
def test_swap_round_trip_byte_identical(fixture, cache_dtype):
    """swap_out -> swap_in into other pages -> swap_out gives the same
    bytes, and the blob has the JAX backend's tree shape (groups of
    layers of dicts of numpy arrays, same names, shapes and dtypes)."""
    spec, params = fixture
    jp, tp = params["fp32"]
    kw = dict(max_slots=2, page_size=8, max_seq=32, num_pages=10,
              cache_dtype=cache_dtype)
    be = SingleDeviceBackend(tp, spec, tsched.SchedulerConfig(**kw), device="cpu")
    prompt = np.zeros((1, 16), np.int32)
    prompt[0, :14] = np.arange(1, 15)
    row = np.zeros((4,), np.int32)
    row[:2] = [3, 5]
    be.admit_full(prompt, 0, 14, row)
    blob = be.swap_out([3, 5])
    be.swap_in(blob, [7, 8])
    again = be.swap_out([7, 8])
    jblob = JaxBackend(jp, spec, jsched.SchedulerConfig(**kw)).swap_out([3, 5])
    assert len(blob) == len(jblob)
    for tg, jg, ag in zip(blob, jblob, again):
        assert len(tg) == len(jg)
        for te, je, ae in zip(tg, jg, ag):
            assert set(te) == set(je)
            for name in te:
                assert isinstance(te[name], np.ndarray)
                assert te[name].shape == je[name].shape
                assert te[name].dtype == je[name].dtype
                np.testing.assert_array_equal(te[name], ae[name])
    assert be.host_page_bytes() == sum(
        a.nbytes // a.shape[0] for g in blob for e in g for a in e.values())


def test_spec_k_and_ring_stacks_refused(fixture):
    spec, params = fixture
    _, tp = params["fp32"]
    cfg = tsched.SchedulerConfig(max_slots=2, page_size=8, max_seq=32,
                                 num_pages=10, spec_k=3)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsched.ContinuousBatchingEngine(tp, spec, cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SingleDeviceBackend(tp, spec, cfg, device="cpu")
    local = ARCHS["gemma3-1b"].scaled_down(layers=2, width=64, vocab=128)
    assert set(local.layer_kinds()) == {"attn_local"}
    cfg = tsched.SchedulerConfig(max_slots=2, page_size=8, max_seq=32,
                                 num_pages=10)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SingleDeviceBackend({}, local, cfg, device="cpu")
    be = SingleDeviceBackend(tp, spec, cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        be.decode(np.zeros((2, 2), np.int32), np.ones(2, np.int32),
                  np.ones(2, np.int32))
    torch.testing.assert_close(be.cache["pos"], torch.zeros(2, dtype=torch.int32))
