"""The port's engine on the two paths of the second slice, against the
JAX package's engine: self-speculative decoding (``spec_k=4``, the
K-token verify window) and flash-attention cold admission
(``attention_impl="pallas"``).

Same fixture as ``test_torch_serve.py``: granite-3-8b scaled to 2
layers, width 64, weights from ``repro.models.lm.init`` bridged into
the port, ``debug_invariants=True`` on both sides.  Greedy streams are
compared with ``assert_close_tokens`` (matching prefix >= 0.9 of the
stream), and where they are identical the host schedulers must have
run the same schedule, so their ``stats`` must be equal.

The speculative workload repeats a segment in every prompt and asks
for 24 new tokens: the greedy streams of the random model fall into
loops that the n-gram tables draft from, so windows really verify
drafts (``spec_steps > 0``, ``spec_accepted > 0``); the JAX package's
own fixture never drafts on this tree (ROADMAP queue 3).
"""
import jax
import numpy as np
import pytest

from repro.configs import ASSIGNED
from repro.models import lm as jlm
from repro.serve import scheduler as jsched
from repro_torch import bridge
from repro_torch.serve import scheduler as tsched
from repro_torch.serve.backend import SingleDeviceBackend
from tolerance import assert_close_tokens


@pytest.fixture(scope="module")
def fixture():
    spec = ASSIGNED["granite-3-8b"].scaled_down(layers=2, width=64, vocab=128)
    jp = jlm.init(jax.random.PRNGKey(0), spec)
    tp = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return spec, jp, tp


def _spec_requests():
    rng = np.random.default_rng(7)
    reqs = []
    for _ in range(4):
        seg = rng.integers(1, 128, size=int(rng.integers(5, 9))).astype(np.int32)
        reqs.append((np.concatenate([seg, seg, seg[:3]]), 24))
    return reqs


def _long_requests():
    """Prompts of 65-256 tokens: with 16-token pages they bucket to 128
    or 256 tokens, the lengths the JAX flash kernel takes."""
    rng = np.random.default_rng(8)
    return [(rng.integers(1, 128, size=n).astype(np.int32), 6)
            for n in (65, 130, 256, 97)]


def _run_jax(jp, spec, kw, reqs):
    cfg = jsched.SchedulerConfig(debug_invariants=True, **kw)
    eng = jsched.ContinuousBatchingEngine(jp, spec, cfg)
    done = eng.run([jsched.Request(i, p.copy(), n)
                    for i, (p, n) in enumerate(reqs)])
    return eng, done


def _run_port(tp, spec, kw, reqs):
    cfg = tsched.SchedulerConfig(debug_invariants=True, **kw)
    eng = tsched.ContinuousBatchingEngine(
        None, spec, cfg, backend=SingleDeviceBackend(tp, spec, cfg, device="cpu"))
    done = eng.run([tsched.Request(i, p.copy(), n)
                    for i, (p, n) in enumerate(reqs)])
    eng.alloc.check()
    assert all(c.status == "ok" for c in done)
    return eng, done


def _compare(tdone, jdone, context):
    identical = True
    for a, b in zip(jdone, tdone):
        assert a.uid == b.uid and len(a.tokens) == len(b.tokens)
        assert_close_tokens(b.tokens, a.tokens, context=f"{context} uid {a.uid}")
        identical &= bool(np.array_equal(a.tokens, b.tokens))
    return identical


@pytest.mark.parametrize("cache_dtype", ["fp32", "int8", "int4"])
def test_spec_engine_matches_jax_and_greedy(fixture, cache_dtype):
    """spec_k=4 in the port against spec_k=4 in the JAX package, and
    against the port's own spec_k=1 engine (greedy acceptance keeps the
    stream the sequential greedy one)."""
    spec, jp, tp = fixture
    kw = dict(max_slots=3, page_size=8, max_seq=64, num_pages=30,
              cache_dtype=cache_dtype)
    reqs = _spec_requests()
    jeng, jdone = _run_jax(jp, spec, dict(kw, spec_k=4), reqs)
    teng, tdone = _run_port(tp, spec, dict(kw, spec_k=4), reqs)
    if _compare(tdone, jdone, f"spec {cache_dtype}"):
        assert dict(teng.stats) == dict(jeng.stats)
    st = teng.stats
    assert st["spec_steps"] > 0 and st["spec_accepted"] > 0, dict(st)
    beng, bdone = _run_port(tp, spec, dict(kw, spec_k=1), reqs)
    _compare(tdone, bdone, f"spec vs greedy {cache_dtype}")
    assert beng.stats["spec_steps"] == 0
    assert st["iterations"] < beng.stats["iterations"]
    # every verify step went through the backend's window path
    assert teng.backend.decode_steps == st["iterations"]


@pytest.mark.parametrize("cache_dtype", ["fp32", "int8", "int4"])
def test_spec_engine_preemption_parity(fixture, cache_dtype):
    """A pool too small for every admitted context forces preemption of
    slots whose verify windows allocate pages ahead.  The port follows
    the JAX spec_k=4 engine, and every page comes back.  At fp32 and
    int8 pages the stream is also the spec_k=1 one.  At int4 pages it is not, in
    either package: request 2 emits one more repeated token than
    greedy (ROADMAP queue 3), so there the port is held to the JAX
    engine only."""
    spec, jp, tp = fixture
    kw = dict(max_slots=4, page_size=8, max_seq=48, num_pages=11,
              cache_dtype=cache_dtype, spec_k=4)
    reqs = _spec_requests()
    jeng, jdone = _run_jax(jp, spec, kw, reqs)
    teng, tdone = _run_port(tp, spec, kw, reqs)
    if _compare(tdone, jdone, f"preempt {cache_dtype}"):
        assert dict(teng.stats) == dict(jeng.stats)
    assert teng.stats["preemptions"] >= 1
    assert teng.stats["spec_steps"] > 0
    if cache_dtype != "int4":
        _, bdone = _run_port(tp, spec, dict(kw, spec_k=1), reqs)
        _compare(tdone, bdone, "preempt vs greedy")
    teng.prefix_cache.flush()
    teng.alloc.check()
    assert teng.alloc.free_pages == teng.layout.num_pages - 1


@pytest.mark.parametrize("cache_dtype", ["fp32", "int4"])
def test_flash_admission_engine_matches_jax(fixture, cache_dtype):
    """``attention_impl="pallas"``: cold admissions run the prompt through
    the flash attention op (the port's plain version on the CPU, the
    JAX package's flash path), prompts of 65-256 tokens."""
    spec, jp, tp = fixture
    kw = dict(max_slots=2, page_size=16, max_seq=288, num_pages=40,
              cache_dtype=cache_dtype, attention_impl="pallas")
    reqs = _long_requests()
    jeng, jdone = _run_jax(jp, spec, kw, reqs)
    teng, tdone = _run_port(tp, spec, kw, reqs)
    if _compare(tdone, jdone, f"flash {cache_dtype}"):
        assert dict(teng.stats) == dict(jeng.stats)
    # and the same streams as the sdpa admission of the port
    _, ndone = _run_port(tp, spec, dict(kw, attention_impl="naive"), reqs)
    _compare(tdone, ndone, f"flash vs sdpa {cache_dtype}")
