"""Per-block parameter shapes (the subset of ``repro.core.blocks`` the
port's dense models need).

Conventions match the JAX package: all linear layers are bias-free and
weights are stored ``(in_dim, out_dim)`` so a layer applies ``x @ W``.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.core.model_config import ModelSpec

Shape = Tuple[int, ...]


def attention_param_shapes(spec: ModelSpec, cross: bool = False) -> Dict[str, Shape]:
    d, q, kv = spec.d_model, spec.q_dim, spec.kv_dim
    pre = "cross_" if cross else ""
    return {
        f"{pre}wq": (d, q),
        f"{pre}wk": (d, kv),
        f"{pre}wv": (d, kv),
        f"{pre}wo": (q, d),
    }


def mlp_param_shapes(spec: ModelSpec, d_ff: int = 0) -> Dict[str, Shape]:
    d = spec.d_model
    ff = d_ff or spec.d_ff
    if ff == 0:
        return {}
    if spec.act in ("silu", "swiglu"):          # gated
        return {"mlp_wi": (d, 2 * ff), "mlp_wo": (ff, d)}
    return {"mlp_wi": (d, ff), "mlp_wo": (ff, d)}


def norm_shapes(spec: ModelSpec, names: Tuple[str, ...]) -> Dict[str, Shape]:
    out: Dict[str, Shape] = {}
    for n in names:
        out[n] = (spec.d_model,)
        if spec.norm == "layernorm":
            out[n + "_b"] = (spec.d_model,)
    return out


def layer_param_shapes(spec: ModelSpec, kind: str) -> Dict[str, Shape]:
    """All parameter shapes for one dense attention layer."""
    if kind not in ("attn", "attn_local", "attn_global"):
        raise NotImplementedError(
            f"layer kind {kind!r} is not ported yet (ROADMAP queue 1 item 7)")
    if spec.cross_attention or spec.moe is not None:
        raise NotImplementedError(
            "cross-attention and MoE layers are not ported yet "
            "(ROADMAP queue 1 item 7)")
    out: Dict[str, Shape] = {}
    out.update(norm_shapes(spec, ("norm1", "norm2")))
    out.update(attention_param_shapes(spec))
    out.update(mlp_param_shapes(spec))
    return out


def global_param_shapes(spec: ModelSpec) -> Dict[str, Shape]:
    """Embedding, head and final norm."""
    if spec.vision_tokens or spec.encoder_layers:
        raise NotImplementedError(
            "vision and encoder frontends are not ported yet "
            "(ROADMAP queue 1 item 7)")
    d, vp = spec.d_model, spec.padded_vocab
    out: Dict[str, Shape] = {"embed": (vp, d)}
    out.update(norm_shapes(spec, ("final_norm",)))
    if not spec.tie_embeddings:
        out["head"] = (d, vp)
    return out


def layer_state_shapes(spec: ModelSpec, kind: str, batch: int,
                       max_seq: int) -> Dict[str, Shape]:
    """Decode-state shapes of one attention layer's contiguous cache; a
    sliding-window layer holds at most one window."""
    kv = (spec.num_kv_heads, spec.head_dim)
    if kind in ("attn", "attn_global", "enc_attn"):
        return {"k": (batch, max_seq, *kv), "v": (batch, max_seq, *kv)}
    if kind == "attn_local":
        w = min(max_seq, spec.sliding_window or max_seq)
        return {"k": (batch, w, *kv), "v": (batch, w, *kv)}
    raise NotImplementedError(
        f"decode state of layer kind {kind!r} is not ported yet "
        "(ROADMAP queue 1 item 7)")
