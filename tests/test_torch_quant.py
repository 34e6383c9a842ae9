"""The port's quantizer against the JAX package's on identical inputs.

Both sides get the same float32 numpy arrays, so quantized bytes must be
EQUAL and scales bitwise equal: the port keeps ``x / scale`` a division,
the ``1e-8`` amax floor and round-half-to-even.  The sweeps include
channels whose amax sits under the floor and values that land exactly
on .5 after division.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.quant import qtypes as jqt
from repro_torch.quant import qtypes as tqt

jq = importlib.import_module("repro.quant.quantize")
tq = importlib.import_module("repro_torch.quant.quantize")

CONFIGS = ["W8_SYM_CHANNEL", "W4_SYM_GROUP", "A8_ASYM_TENSOR",
           "A8_SYM_TENSOR"]


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def _weights(seed: int, K: int = 128, N: int = 48) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(K, N)) * rng.uniform(0.01, 3.0)).astype(np.float32)
    x[:, 3] = 0.0                                   # amax 0 -> floor
    x[:64, 5] = rng.normal(size=64) * 1e-10         # amax under 1e-8
    # exact .5 ties after division: amax 127 per channel, values k + .5
    x[:, 7] = 0.0
    x[0, 7] = 127.0
    x[1:9, 7] = np.arange(8) + 0.5
    return x


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_bytes_and_scales_equal_jax(name, seed):
    x = _weights(seed)
    jt = jq.quantize(jnp.asarray(x), getattr(jqt, name))
    tt = tq.quantize(torch.from_numpy(x), getattr(tqt, name))
    np.testing.assert_array_equal(np.asarray(jt.q), tt.q.numpy())
    np.testing.assert_array_equal(_bits(jt.scale), _bits(tt.scale.numpy()))
    if jt.zero is None:
        assert tt.zero is None
    else:
        np.testing.assert_array_equal(_bits(jt.zero), _bits(tt.zero.numpy()))
    np.testing.assert_array_equal(_bits(jq.dequantize(jt)),
                                  _bits(tq.dequantize(tt).numpy()))


def test_half_ties_round_to_even():
    """x / scale exactly k + .5 rounds to the even neighbour on both
    sides (127 sets amax so scale is exactly 1.0)."""
    x = np.zeros((64, 2), np.float32)
    x[0] = 127.0
    x[1:9, 0] = np.arange(8) + 0.5
    x[1:9, 1] = -(np.arange(8) + 0.5)
    tt = tq.quantize(torch.from_numpy(x), tqt.W8_SYM_CHANNEL)
    assert tt.scale.numpy().tolist() == [[1.0, 1.0]]
    assert tt.q[1:9, 0].tolist() == [0, 2, 2, 4, 4, 6, 6, 8]
    jt = jq.quantize(jnp.asarray(x), jqt.W8_SYM_CHANNEL)
    np.testing.assert_array_equal(np.asarray(jt.q), tt.q.numpy())


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("seed", [0, 1])
def test_kv_quantizers_equal_jax(kind, seed):
    rng = np.random.default_rng(10 + seed)
    x = rng.normal(size=(6, 8, 2, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0                                # amax 0 row
    x[1, 1, 1] = 1e-12                              # under the floor
    qmax = 127.0 if kind == "int8" else 7.0
    x[2, 2, 0] = 0.0
    x[2, 2, 0, 0] = qmax                            # scale exactly 1.0
    x[2, 2, 0, 1:5] = [0.5, 1.5, 2.5, -3.5]         # exact ties
    jf = getattr(jq, f"quantize_kv_{kind}")
    tf = getattr(tq, f"quantize_kv_{kind}")
    jqv, jsc = jf(jnp.asarray(x))
    tqv, tsc = tf(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(jqv), tqv.numpy())
    np.testing.assert_array_equal(_bits(jsc), _bits(tsc.numpy()))
    assert tqv[2, 2, 0, 1:5].tolist() == [0, 2, 2, -4]
    # lane-major transpose of the scales: same layout both sides
    np.testing.assert_array_equal(
        _bits(jq.lane_major_scales(jsc)),
        _bits(tq.lane_major_scales(tsc).numpy()))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_pack_unpack_int4_bytes_equal_jax(axis):
    rng = np.random.default_rng(axis)
    q = rng.integers(-8, 8, size=(8, 6, 4)).astype(np.int8)
    jp = np.asarray(jq.pack_int4(jnp.asarray(q), axis=axis))
    tp = tq.pack_int4(torch.from_numpy(q), axis=axis)
    np.testing.assert_array_equal(jp, tp.numpy())
    np.testing.assert_array_equal(tq.unpack_int4(tp, axis=axis).numpy(), q)
    np.testing.assert_array_equal(
        np.asarray(jq.unpack_int4(jnp.asarray(jp), axis=axis)),
        tq.unpack_int4(torch.from_numpy(jp), axis=axis).numpy())
    # low nibble = even position
    first = np.take(q, [0], axis=axis).astype(np.int32) & 0x0F
    np.testing.assert_array_equal(np.take(jp, [0], axis=axis) & 0x0F, first)


def test_stacked_dequantize_matches_per_layer():
    rng = np.random.default_rng(3)
    ws = [torch.from_numpy(rng.normal(size=(64, 32)).astype(np.float32))
          for _ in range(3)]
    ts = [tq.quantize(w, tqt.W4_SYM_GROUP) for w in ws]
    stacked = tqt.QuantizedTensor(q=torch.stack([t.q for t in ts]),
                                  scale=torch.stack([t.scale for t in ts]),
                                  zero=None, config=tqt.W4_SYM_GROUP)
    assert stacked.shape == (3, 64, 32)
    out = tq.dequantize(stacked)
    for i, t in enumerate(ts):
        torch.testing.assert_close(out[i], tq.dequantize(t), rtol=0, atol=0)


def _reciprocal_breakers(d: float, n: int) -> np.ndarray:
    """``n`` float32 values x for which x * fl(1/d) is not the true
    quotient fl(x / d): what a CUDA tensor's division by a Python number
    computes, and where it would move a scale by one ulp."""
    rng = np.random.default_rng(int(d))
    x = rng.uniform(1e-3, 8.0, size=200_000).astype(np.float32)
    d32 = np.float32(d)
    bad = x[(x / d32) != x * (np.float32(1.0) / d32)]
    assert len(bad) >= n
    return bad[:n]


# (config or KV quantizer, the divisor of its scale)
_DIVISIONS = [("W8_SYM_CHANNEL", 127), ("W4_SYM_GROUP", 7),
              ("A8_ASYM_CHANNEL", 255), ("A4_ASYM_GROUP", 15),
              ("kv_int8", 127), ("kv_int4", 7)]


@pytest.mark.parametrize("name,d", _DIVISIONS)
def test_scales_are_true_division(name, d):
    """At amax (or hi - lo) values where a multiply by the reciprocal
    differs from float32 division, every scale is numpy's true quotient,
    bit for bit, and the JAX package's.  On the CPU, where torch divides
    truly; a CUDA tensor divided by a Python number takes the reciprocal
    path (ROADMAP queue 3), which ``chip_smoke.py`` counts on the card."""
    amax = _reciprocal_breakers(d, 32)
    if name.startswith("kv_"):
        x = np.zeros((32, 2, 16), np.float32)
        x[:, 0, 3] = amax
        x[:, 1, 5] = -amax
        tsc = getattr(tq, f"quantize_kv_{name[3:]}")(torch.from_numpy(x))[1]
        jsc = getattr(jq, f"quantize_kv_{name[3:]}")(jnp.asarray(x))[1]
        want = np.repeat((amax / np.float32(d))[:, None], 2, axis=1)[..., None]
    else:
        bits = 8 if "8" in name.split("_")[0] else 4
        sym = name.split("_")[1] == "SYM"
        gran = name.split("_")[2].lower()
        cfgs = [m.QuantConfig(bits=bits, symmetric=sym, granularity=gran,
                              group_size=32) for m in (tqt, jqt)]
        # one channel per value: the channel's amax (and, for the
        # asymmetric case, hi - lo with lo = 0) is that value
        x = np.zeros((32, 32), np.float32)
        x[0] = amax
        x[1] = amax / 3
        tsc = tq.compute_scale_zero(torch.from_numpy(x), cfgs[0])[0]
        jsc = jq.compute_scale_zero(jnp.asarray(x), cfgs[1])[0]
        want = (amax / np.float32(d)).reshape(np.asarray(jsc).shape)
    np.testing.assert_array_equal(_bits(tsc.numpy()), _bits(want))
    np.testing.assert_array_equal(_bits(jsc), _bits(want))
