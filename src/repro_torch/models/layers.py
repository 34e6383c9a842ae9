"""Layer functions over param dicts, the dense subset of
``repro.models.layers`` in plain tensor ops.

Parameter names and shapes come from ``core.blocks``; weights are
``(in, out)`` and apply as ``x @ W`` through ``qdot``.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.core.model_config import ModelSpec
from repro_torch.kernels import ops as kops
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.quant.qlinear import qdot

Params = Dict[str, torch.Tensor]
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms / activations / RoPE
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(torch.float32))).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    # scale stored as (1 + s) like rmsnorm, so zero-init is identity
    return (out * (1.0 + scale.to(torch.float32))
            + bias.to(torch.float32)).to(x.dtype)


def norm(spec: ModelSpec, p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    if spec.norm == "layernorm":
        return layernorm(x, p[name], p[name + "_b"])
    return rmsnorm(x, p[name])


def activation(spec: ModelSpec, x: torch.Tensor) -> torch.Tensor:
    if spec.act in ("silu", "swiglu"):
        return F.silu(x)
    if spec.act == "gelu":
        return F.gelu(x, approximate="tanh")       # jax.nn.gelu's default
    if spec.act == "relu2":
        r = F.relu(x)
        return r * r
    raise ValueError(spec.act)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions broadcastable to (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions.to(torch.float32)[..., None] * freq          # (..., S, half)
    sin = torch.sin(ang)[..., None, :]                           # (..., S, 1, half)
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def grouped_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q (B,Sq,H,D), k (B,Sk,KV,D) -> f32 logits (B,KV,G,Sq,Sk) without
    repeating KV (G = H // KV)."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, D).to(torch.float32)
    return torch.einsum("bskgd,btkd->bkgst", qg, k.to(torch.float32))


def grouped_out(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p (B,KV,G,Sq,Sk) f32 probs, v (B,Sk,KV,D) -> f32 (B,Sq,H,D)."""
    B, KV, G, Sq, Sk = p.shape
    out = torch.einsum("bkgst,btkd->bskgd", p, v.to(torch.float32))
    return out.reshape(B, Sq, KV * G, out.shape[-1])


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
         window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """Full-materialization grouped-query attention in plain tensor ops:
    the flash kernel's plain version, with the logit softcap.  A row with
    no valid key gives zeros; no model path makes one (queries are
    end-aligned with Sq <= Sk, so each sees at least its own key)."""
    return flash_attention_plain(q, k, v, causal=causal, window=window,
                                 softcap=softcap)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int, *, window: int = 0,
                     ring: bool = False) -> torch.Tensor:
    """Single-token attention against a contiguous cache: q (B, 1, H, D),
    caches (B, S, KV, D), ``pos`` the current token's absolute position.
    On a ring buffer (``ring=True``) entry j holds absolute position
    ``pos - ((pos - j) mod S)``; never-written entries are masked."""
    D = q.shape[-1]
    S = k_cache.shape[1]
    s = grouped_scores(q, k_cache) / math.sqrt(D)                # (B,KV,G,1,S)
    idx = torch.arange(S, device=q.device)
    if ring:
        abs_pos = pos - torch.remainder(pos - idx, S)
        valid = abs_pos >= 0
        if window:
            valid &= (pos - abs_pos) < window
    else:
        valid = idx <= pos
        if window:
            valid &= (pos - idx) < window
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return grouped_out(p, v_cache).to(q.dtype)


def attention_block(spec: ModelSpec, p: Params, x: torch.Tensor,
                    positions: torch.Tensor, *, kind: str = "attn",
                    impl: str = "naive") -> torch.Tensor:
    """Projections + RoPE + attention (+output proj).  No residual/norm.
    ``impl="pallas"`` takes the flash-attention kernel (no softcap, as in
    the JAX package); ``"naive"``/``"auto"`` take ``sdpa``."""
    if impl not in ("naive", "auto", "pallas"):
        raise NotImplementedError(
            f"attention impl {impl!r} is not ported (want naive | auto | "
            "pallas)")
    B, S, _ = x.shape
    H, KV, D = spec.num_heads, spec.num_kv_heads, spec.head_dim
    q = qdot(x, p["wq"]).reshape(B, S, H, D)
    k = qdot(x, p["wk"]).reshape(B, S, KV, D)
    v = qdot(x, p["wv"]).reshape(B, S, KV, D)
    causal = kind != "enc_attn"
    if causal:
        q = rope(q, positions, spec.rope_theta)
        k = rope(k, positions, spec.rope_theta)
    window = spec.sliding_window if kind == "attn_local" else 0
    if impl == "pallas":
        o = kops.flash_attention(q, k, v, causal=causal, window=window)
    else:
        o = sdpa(q, k, v, causal=causal, window=window,
                 softcap=spec.attn_logit_softcap)
    return qdot(o.reshape(B, S, H * D), p["wo"])


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_block(spec: ModelSpec, p: Params, x: torch.Tensor, *,
              impl: str = "auto") -> torch.Tensor:
    """Gated (or plain) MLP; ``impl`` goes to ``qdot`` (``"plain"`` only
    to hold the kernels against their plain versions)."""
    h = qdot(x, p["mlp_wi"], impl=impl)
    if spec.act in ("silu", "swiglu"):
        gate, up = torch.chunk(h, 2, dim=-1)
        h = activation(spec, gate) * up
    else:
        h = activation(spec, h)
    return qdot(h, p["mlp_wo"], impl=impl)
