"""The port's static engine (``repro_torch.serve.engine``) and its
contiguous decode path against the JAX package, on the CPU.

Fixtures: Gemma3-1B scaled to width 64, vocab 128, window 8, at 2 layers
(both ``attn_local``: with ``max_seq == window`` their contiguous caches
take the one-window RING layout) and at 6 layers (5 local, 1 global, the
model's own pattern).  Weights are made by ``repro.models.lm.init`` (and
``quantize_params`` for int8/int4) and bridged into the port, so both
packages hold the same bytes.

Greedy streams must be EQUAL: on these fixtures the two packages' logits
differ only in the last float bits and no step sits on an argmax
near-tie (the same holds for the paged engines of ``test_torch_serve``).
Logits of single steps are compared with ``assert_close_logits`` at its
default band (rtol 2e-5, atol 1e-5): f32 summation order only.
Sampling (``temperature > 0``) draws from a ``torch.Generator`` and
cannot give ``jax.random``'s tokens, so it is checked for determinism
and range only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.quant.qlinear import quantize_params as jax_quantize_params
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import generate as jax_generate
from repro_torch import bridge
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.serve import engine as teng
from repro_torch.serve import scheduler as tsched
from repro_torch.serve.backend import SingleDeviceBackend
from tolerance import assert_close_logits

WINDOW = 8


def _spec(layers):
    return JAX_ARCHS["gemma3-1b"].scaled_down(
        layers=layers, width=64, vocab=128).with_(sliding_window=WINDOW)


@pytest.fixture(scope="module")
def fixture():
    out = {}
    for layers in (2, 6):
        spec = _spec(layers)
        base = jlm.init(jax.random.PRNGKey(layers), spec)
        for prec in ("fp32", "int8", "int4"):
            jp = base if prec == "fp32" else jax_quantize_params(base, prec)
            out[layers, prec] = (spec, jp, bridge.params_from_jax(
                jax.tree_util.tree_map(np.asarray, jp), "cpu"))
    return out


def _prompts(seed, B=2, S=13):
    return np.random.default_rng(seed).integers(1, 128, size=(B, S)).astype(np.int32)


@pytest.mark.parametrize("prec", ["fp32", "int8", "int4"])
@pytest.mark.parametrize("layers,max_seq", [(2, 40), (2, WINDOW), (6, 40)])
def test_generate_matches_jax(fixture, layers, max_seq, prec):
    """Greedy ``generate``: 20 decode steps after a 13-token prompt.
    ``max_seq == window`` on the local stack runs the contiguous ring
    layout (write at ``pos % W``, prefill keeps the last window); 40
    keeps flat buffers whose local layers mask the window."""
    spec, jp, tp = fixture[layers, prec]
    prompt = _prompts(layers + max_seq)
    a = jax_generate(jp, spec, {"tokens": jnp.asarray(prompt)}, 20,
                     JaxServeConfig(max_seq=max_seq, attention_impl="naive"))
    b = teng.generate(tp, spec, {"tokens": torch.from_numpy(prompt).long()}, 20,
                      teng.ServeConfig(max_seq=max_seq, attention_impl="naive",
                                       weight_precision=prec))
    assert b["tokens"].shape == (2, 21)
    np.testing.assert_array_equal(b["tokens"].numpy(), np.asarray(a["tokens"]))
    assert int(b["cache_pos"]) == int(a["cache_pos"]) == 13 + 20


@pytest.mark.parametrize("max_seq", [40, WINDOW])
def test_prefill_and_decode_step_logits_match_jax(fixture, max_seq):
    """Contiguous ``prefill`` (incl. the ring layout when ``max_seq ==
    window``) and three ``decode_step`` calls, int4 weights: logits within
    the default band and the cache buffers within the prefill band."""
    spec, jp, tp = fixture[2, "int4"]
    prompt = _prompts(3)
    jl, jc = jlm.prefill(jp, spec, {"tokens": jnp.asarray(prompt)},
                         max_seq=max_seq, impl="naive")
    tl, tc = tlm.prefill(tp, spec, {"tokens": torch.from_numpy(prompt).long()},
                         max_seq=max_seq)
    assert_close_logits(tl.numpy(), np.asarray(jl), context="prefill")
    for jg, tg in zip(jc["groups"], tc["groups"]):
        for je, te in zip(jg, tg):
            for name in ("k", "v"):
                assert te[name].shape == je[name].shape == (2, max_seq, 1, 16)
                np.testing.assert_allclose(te[name].numpy(), np.asarray(je[name]),
                                           rtol=2e-5, atol=2e-6)
    tok = np.asarray([[5], [9]], np.int32)
    for step in range(3):
        jl, jc = jlm.decode_step(jp, spec, jc, jnp.asarray(tok))
        tl, tc = tlm.decode_step(tp, spec, tc, torch.from_numpy(tok).long())
        assert_close_logits(tl.numpy(), np.asarray(jl), context=f"step {step}")
        tok = np.asarray(jnp.argmax(jl[:, 0], -1), np.int32)[:, None]
    assert int(tc["pos"]) == int(jc["pos"]) == 16


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("window", [0, 5])
def test_decode_attention_matches_jax(ring, window):
    """``layers.decode_attention`` over flat and ring buffers, with and
    without a window, at positions before and after the ring wraps."""
    rng = np.random.default_rng(window + ring)
    q = rng.normal(size=(2, 1, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 8, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 8, 2, 16)).astype(np.float32)
    for pos in ((3, 7, 12, 21) if ring else (0, 3, 7)):
        a = jlayers.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), pos, window=window,
                                     ring=ring)
        b = tlayers.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), pos, window=window,
                                     ring=ring)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=2e-6,
                                   atol=2e-6, err_msg=f"pos {pos}")


def test_init_cache_matches_jax_shapes(fixture):
    """``init_cache``: per-layer zero buffers of the JAX shapes (local
    layers hold at most one window), a scalar pos; ``paged=`` returns the
    paged layout."""
    for layers in (2, 6):
        spec = _spec(layers)
        for max_seq in (4, 40):
            jc = jlm.init_cache(spec, 3, max_seq)
            tc = tlm.init_cache(spec, 3, max_seq, device="cpu")
            assert tc["pos"].shape == () and int(tc["pos"]) == 0
            for jg, tg in zip(jc["groups"], tc["groups"]):
                assert len(jg) == len(tg)
                for je, te in zip(jg, tg):
                    assert set(te) == {"k", "v"} == set(je)
                    for name in te:
                        assert tuple(te[name].shape) == je[name].shape
                        assert not te[name].any()
    paged = tlm.init_cache(_spec(2), 2, 32, "int8",
                           paged=tlm.PagedLayout(num_pages=5, page_size=4),
                           device="cpu")
    assert "block_tables" in paged and "k_scale" in paged["groups"][0][0]


def test_ring_engine_matches_static_generate(fixture):
    """As ``test_serve_scheduler.py`` holds the JAX ring engine to the
    JAX static engine: the port's ring engine (``windowed_kv=True``, a
    pool too small for flat tables, a shared template whose pages fall
    out of the window) emits, per request, the port's static windowed
    ``generate`` stream."""
    spec, _, tp = fixture[2, "fp32"]
    rng = np.random.default_rng(9)
    tmpl = rng.integers(1, 128, size=9).astype(np.int32)
    prompts = [np.concatenate([tmpl, rng.integers(
        1, 128, size=int(rng.integers(2, 6))).astype(np.int32)]) for _ in range(5)]
    cfg = tsched.SchedulerConfig(max_slots=3, page_size=4, max_seq=40,
                                 num_pages=8, windowed_kv=True,
                                 debug_invariants=True)
    eng = tsched.ContinuousBatchingEngine(
        None, spec, cfg, backend=SingleDeviceBackend(tp, spec, cfg, device="cpu"))
    done = sorted(eng.run([tsched.Request(i, p.copy(), 20)
                           for i, p in enumerate(prompts)]), key=lambda c: c.uid)
    assert eng.ring and eng.stats["ring_recycled_pages"] > 0
    assert eng.stats["ring_shared_released"] > 0
    scfg = teng.ServeConfig(max_seq=40, attention_impl="naive")
    for p, c in zip(prompts, done):
        out = teng.generate(tp, spec, {"tokens": torch.from_numpy(p[None]).long()},
                            19, scfg)
        np.testing.assert_array_equal(out["tokens"][0].numpy(), c.tokens)
    eng.alloc.check()


def test_sampling_is_deterministic_and_in_range(fixture):
    """``temperature > 0`` draws from the caller's generator: one seed
    gives one stream, another seed another, every id in the vocab."""
    spec, _, tp = fixture[6, "int8"]
    batch = {"tokens": torch.from_numpy(_prompts(5)).long()}
    cfg = teng.ServeConfig(max_seq=40, temperature=1.5)
    runs = [teng.generate(tp, spec, batch, 12, cfg,
                          generator=torch.Generator().manual_seed(s))["tokens"]
            for s in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    for r in runs:
        assert r.shape == (2, 13)
        assert int(r.min()) >= 0 and int(r.max()) < spec.padded_vocab
    greedy = teng.generate(tp, spec, batch, 12, teng.ServeConfig(max_seq=40))
    assert not torch.equal(runs[0], greedy["tokens"])


def test_cached_generate_and_step_factories(fixture):
    """``jitted_generate`` hands back one cached closure per (spec, cfg)
    that returns ``generate``'s tokens; ``make_prefill_step`` and
    ``make_serve_step`` run ``prefill`` and ``decode_step``."""
    spec, _, tp = fixture[2, "int8"]
    cfg = teng.ServeConfig(max_seq=40, attention_impl="naive")
    fn = teng.jitted_generate(spec, cfg)
    assert teng.jitted_generate(spec, cfg) is fn
    batch = {"tokens": torch.from_numpy(_prompts(6)).long()}
    want = teng.generate(tp, spec, batch, 6, cfg)["tokens"]
    assert torch.equal(fn(tp, batch, 6)["tokens"], want)
    logits, cache = teng.make_prefill_step(spec, 40, impl="naive")(tp, batch)
    assert torch.equal(torch.argmax(logits[:, 0], -1), want[:, 0])
    logits, cache = teng.make_serve_step(spec)(tp, cache, want[:, :1])
    assert torch.equal(torch.argmax(logits[:, 0], -1), want[:, 1])
    assert int(cache["pos"]) == 14
