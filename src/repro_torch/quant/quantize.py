"""Quantize / dequantize primitives (paper §II eqs 1-4), ported function
by function from ``repro.quant.quantize``.

The arithmetic is kept operation for operation so that identical float
inputs give identical bytes: ``x / scale`` stays a division, the amax
floor is ``1e-8``, and ``torch.round`` rounds half to even as
``jnp.round`` does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.quant.qtypes import QuantConfig, QuantizedTensor


def _reduce_axes(x: torch.Tensor, cfg: QuantConfig) -> Tuple[int, ...]:
    if cfg.granularity == "tensor":
        return tuple(range(x.ndim))
    axis = cfg.axis % x.ndim
    return tuple(i for i in range(x.ndim) if i != axis)


def _group_reshape(x: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """group quant: split the *contraction* dim (axis 0 for (in,out) weights)
    into groups of cfg.group_size."""
    g = cfg.group_size
    assert x.shape[0] % g == 0, f"dim {x.shape[0]} not divisible by group {g}"
    return x.reshape(x.shape[0] // g, g, *x.shape[1:])


def compute_scale_zero(x: torch.Tensor, cfg: QuantConfig):
    """Scale (and zero point for asymmetric) per eq. (1)/(3)."""
    if cfg.granularity == "group":
        x = _group_reshape(x, cfg)
        red: Tuple[int, ...] = (1,)
    else:
        red = _reduce_axes(x, cfg)
    if cfg.symmetric:
        amax = torch.amax(torch.abs(x), dim=red, keepdim=True)
        return torch.clamp_min(amax, 1e-8) / cfg.qmax, None
    lo = torch.amin(x, dim=red, keepdim=True)
    hi = torch.amax(x, dim=red, keepdim=True)
    scale = torch.clamp_min(hi - lo, 1e-8) / (cfg.qmax - cfg.qmin)
    zero = lo - cfg.qmin * scale
    return scale, zero


def quantize_values(x: torch.Tensor, cfg: QuantConfig):
    """x -> (int8 values in [qmin, qmax], scale, zero). eq. (1)/(3)."""
    scale, zero = compute_scale_zero(x, cfg)
    xx = _group_reshape(x, cfg) if cfg.granularity == "group" else x
    if zero is None:
        q = torch.round(xx / scale)             # eq. (1)
    else:
        q = torch.round((xx - zero) / scale)    # eq. (3); z maps lo -> qmin
    q = torch.clamp(q, cfg.qmin, cfg.qmax).to(torch.int8)
    if cfg.granularity == "group":
        q = q.reshape(x.shape)
    return q, scale, zero


def dequantize_values(q: torch.Tensor, scale: torch.Tensor,
                      zero: Optional[torch.Tensor], cfg: QuantConfig,
                      out_dtype=torch.float32) -> torch.Tensor:
    """eq. (2)/(4)."""
    if cfg.granularity == "group":
        qg = _group_reshape(q.to(torch.float32), cfg)
        x = qg * scale if zero is None else qg * scale + zero
        return x.reshape(q.shape).to(out_dtype)
    qf = q.to(torch.float32)
    if zero is None:
        return (qf * scale).to(out_dtype)        # eq. (2)
    return (qf * scale + zero).to(out_dtype)     # eq. (4)


def _quantize_kv(x: torch.Tensor, qmax: float):
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) / qmax
    q = torch.clamp(torch.round(xf / scale), -qmax, qmax)
    return q.to(torch.int8), scale


def quantize_kv_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the last (head_dim) axis for KV-cache rows:
    x (..., D) -> (q int8 (..., D), scale f32 (..., 1)); dequant is
    ``q * scale``."""
    return _quantize_kv(x, 127.0)


def quantize_kv_int4(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int4 KV-cache rows: x (..., D) -> (q int8 in [-7, 7],
    scale f32 (..., 1)).  Values are UNPACKED; page pools nibble-pack
    pairs of adjacent tokens with ``pack_int4(..., axis=token_axis)``."""
    return _quantize_kv(x, 7.0)


# ---------------------------------------------------------------------------
# int4 nibble packing: two int4 values per int8 byte along ``axis``
# (weights pack the contraction dim; KV page pools pack the token dim)
# ---------------------------------------------------------------------------

def to_int8_wrapping(u: torch.Tensor) -> torch.Tensor:
    """Integer tensor holding byte values 0..255 -> int8 with the same
    bits (two's complement), without relying on overflowing casts."""
    return torch.where(u >= 128, u - 256, u).to(torch.int8)


def pack_int4(q: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Size-2n ``axis`` of int8 in [-8, 7] -> size-n int8, low nibble =
    even positions."""
    assert q.shape[axis] % 2 == 0
    qm = torch.movedim(q, axis, 0).to(torch.int32)
    lo = qm[0::2] & 0x0F
    hi = (qm[1::2] & 0x0F) << 4
    return torch.movedim(to_int8_wrapping(lo | hi), 0, axis)


def unpack_int4(p: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Inverse of pack_int4 (sign-extends nibbles)."""
    pm = torch.movedim(p, axis, 0).to(torch.int32)
    lo = pm & 0x0F
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = (pm >> 4) & 0x0F
    hi = torch.where(hi >= 8, hi - 16, hi)
    out = torch.stack([lo, hi], dim=1)
    out = out.reshape(pm.shape[0] * 2, *pm.shape[1:]).to(torch.int8)
    return torch.movedim(out, 0, axis)


def lane_major_scales(s: torch.Tensor) -> torch.Tensor:
    """Per-token KV scales (..., page, KV, 1) -> (..., KV, page), the
    token-dim-last layout of the scale pools."""
    return torch.movedim(s[..., 0], -2, -1)


def quantize(x: torch.Tensor, cfg: QuantConfig, pack: bool = True) -> QuantizedTensor:
    q, scale, zero = quantize_values(x, cfg)
    if cfg.bits == 4 and pack:
        q = pack_int4(q)
    return QuantizedTensor(q=q, scale=scale, zero=zero, config=cfg)


def dequantize(t: QuantizedTensor, out_dtype=torch.float32) -> torch.Tensor:
    if t.q.ndim > 2:                      # stacked layers: map over lead
        return torch.stack([
            dequantize(QuantizedTensor(
                q=t.q[i], scale=t.scale[i],
                zero=None if t.zero is None else t.zero[i], config=t.config),
                out_dtype)
            for i in range(t.q.shape[0])])
    q = t.q
    if t.config.bits == 4:
        q = unpack_int4(q)
    return dequantize_values(q, t.scale, t.zero, t.config, out_dtype=out_dtype)
