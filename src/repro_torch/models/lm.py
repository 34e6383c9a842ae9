"""The paged-serving subset of ``repro.models.lm`` in PyTorch.

Parameters are ``{"global": {name: tensor}, "groups": [[{name: tensor}
per layer] per group]}``: per-layer tensors where the JAX package stacks
layers, weights ``(in, out)``.  The paged cache keeps the JAX layout:
per-layer pools ``(P, page, KV, D)`` (int4: ``(P, page/2, KV, D)``) with
scales ``(P, KV, page)``, per-slot ``block_tables`` and ``pos``.

The cache functions update the pools IN PLACE (the JAX versions return
new arrays); they also return the cache so call sites read alike.

Entry points:
    init(seed, spec, device=)                      -> params
    prefill(params, spec, batch, true_len=)        -> (logits, contiguous cache)
    init_paged_cache(spec, batch, max_seq, layout) -> paged cache
    prefill_paged(...)                             -> (logits, cache)  suffix prefill
    decode_step_paged(params, spec, cache, tokens) -> (logits, cache)  one token
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.core import blocks
from repro_torch.core.model_config import ModelSpec
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.quant.qlinear import dequant_param, qdot
from repro_torch.quant.quantize import (quantize_kv_int4, quantize_kv_int8,
                                        to_int8_wrapping, unpack_int4)

Params = Dict[str, Any]

# ---------------------------------------------------------------------------
# Layer grouping
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Group:
    kind: str          # attn | attn_local | attn_global
    base: int          # first layer index
    n: int             # number of layers


def group_plan(spec: ModelSpec) -> List[Group]:
    kinds = list(spec.layer_kinds())
    if spec.ssm is not None and spec.attn_every:
        kinds = ["ssm_shared" if (i + 1) % spec.attn_every == 0 else k
                 for i, k in enumerate(kinds)]
    groups: List[Group] = []
    i = 0
    while i < len(kinds):
        j = i
        while j < len(kinds) and kinds[j] == kinds[i]:
            j += 1
        groups.append(Group(kinds[i], i, j - i))
        i = j
    return groups


def _base_kind(kind: str) -> str:
    return "ssm" if kind == "ssm_shared" else kind


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_param(gen: torch.Generator, name: str, shape, dtype, n_layers: int,
                device) -> torch.Tensor:
    if len(shape) == 0 or name.endswith("_b") or "bias" in name:
        return torch.zeros(shape, dtype=dtype, device=device)
    if "norm" in name:
        return torch.zeros(shape, dtype=dtype, device=device)  # stored as (1 + scale)
    std = 0.02
    if name.endswith(("wo", "out_proj", "ml_down")):
        std = 0.02 / math.sqrt(max(1, 2 * n_layers))
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * std).to(dtype)


def init(seed: Union[int, torch.Generator], spec: ModelSpec, *,
         device=None, dtype=torch.float32) -> Params:
    """Random weights from a seeded ``torch.Generator`` with the JAX
    package's per-name rules (zero norms and biases, N(0, 0.02), output
    projections scaled by 1/sqrt(2 L)).  The numbers differ from
    ``jax.random``'s; tests share weights through ``bridge``."""
    if isinstance(seed, torch.Generator):
        gen = seed
        dev = gen.device
    else:
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
    n_total = spec.num_layers + spec.encoder_layers
    params: Params = {"global": {}, "groups": []}
    for name, shape in blocks.global_param_shapes(spec).items():
        params["global"][name] = _init_param(gen, name, shape, dtype, n_total, dev)
    for g in group_plan(spec):
        shapes = blocks.layer_param_shapes(spec, _base_kind(g.kind))
        params["groups"].append([
            {name: _init_param(gen, name, shape, dtype, n_total, dev)
             for name, shape in shapes.items()}
            for _ in range(g.n)])
    return params


# ---------------------------------------------------------------------------
# Blocks with residual/norm wiring
# ---------------------------------------------------------------------------

def _check_dense(kind: str) -> str:
    base = _base_kind(kind)
    if base not in ("attn", "attn_local", "attn_global"):
        raise NotImplementedError(
            f"layer kind {kind!r} is not ported yet (ROADMAP queue 1 item 7)")
    return base


def _layer_forward(spec: ModelSpec, kind: str, p: Params, x, positions,
                   impl: str) -> torch.Tensor:
    """Full residual attention + MLP layer."""
    base = _check_dense(kind)
    h = L.attention_block(spec, p, L.norm(spec, p, "norm1", x), positions,
                          kind=base, impl=impl)
    x = x + h
    return x + L.mlp_block(spec, p, L.norm(spec, p, "norm2", x))


def _embed(params, spec: ModelSpec, tokens: torch.Tensor) -> torch.Tensor:
    x = params["global"]["embed"][tokens.long()]
    if spec.name.startswith("gemma"):
        x = x * math.sqrt(spec.d_model)
    return x


def _lm_head(params, spec: ModelSpec, x, impl: str = "auto") -> torch.Tensor:
    g = params["global"]
    x = L.norm(spec, g, "final_norm", x)
    if spec.tie_embeddings:
        return torch.matmul(x, dequant_param(g["embed"]).to(x.dtype).T)
    return qdot(x, g["head"], impl=impl)


# ---------------------------------------------------------------------------
# Paged cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PagedLayout:
    """``num_pages`` physical pages of ``page_size`` tokens, shared by up
    to ``batch`` slots via per-slot block tables of ``pages_per_slot``
    entries.  Page 0 is the null page inactive slots point at."""
    num_pages: int
    page_size: int = 16
    pages_per_slot: int = 0          # 0 -> derive from max_seq

    def slots_pages(self, max_seq: int) -> int:
        return self.pages_per_slot or -(-max_seq // self.page_size)


def paged_page_size(cache) -> int:
    """Token capacity of one page (from the scale pool when quantized:
    the int4 value pool's token dim is packed to half)."""
    entry = cache["groups"][0][0]
    if "k_scale" in entry:
        return entry["k_scale"].shape[-1]
    return entry["k_pages"].shape[1]


def _paged_quant(entry) -> str:
    """none | int8 | int4 — int4 iff the value pool's token dim is half
    the scale pool's."""
    if "k_scale" not in entry:
        return "none"
    return ("int4" if entry["k_pages"].shape[1] != entry["k_scale"].shape[-1]
            else "int8")


def init_paged_cache(spec: ModelSpec, batch: int, max_seq: int,
                     layout: PagedLayout, dtype: str = "fp32", *,
                     device=None) -> Params:
    """Per-layer page pools + per-slot block tables (zeros) for an
    attention-only stack; ``dtype`` is "fp32" | "int8" | "int4"."""
    for kind in spec.layer_kinds():
        if _base_kind(kind) not in ("attn", "attn_local", "attn_global"):
            raise NotImplementedError(
                f"paged cache: unsupported layer kind {kind!r}")
    if spec.cross_attention or spec.encoder_layers:
        raise NotImplementedError("paged cache: cross-attention/encoder")
    dev = resolve_device(device)
    cdt = dtype
    if cdt not in ("fp32", "int8", "int4"):
        raise ValueError(f"cache dtype {cdt!r} (want fp32|int8|int4)")
    if cdt == "int4" and layout.page_size % 2:
        raise ValueError(f"int4 pages need an even page_size, "
                         f"got {layout.page_size}")
    pps = layout.slots_pages(max_seq)
    cache: Params = {
        "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
        "block_tables": torch.zeros((batch, pps), dtype=torch.int32, device=dev),
        "groups": [],
    }
    KV, D = spec.num_kv_heads, spec.head_dim
    tok = layout.page_size // 2 if cdt == "int4" else layout.page_size
    pool_dtype = torch.float32 if cdt == "fp32" else torch.int8
    pool = (layout.num_pages, tok, KV, D)
    for g in group_plan(spec):
        layers = []
        for _ in range(g.n):
            entry = {"k_pages": torch.zeros(pool, dtype=pool_dtype, device=dev),
                     "v_pages": torch.zeros(pool, dtype=pool_dtype, device=dev)}
            if cdt != "fp32":
                sshape = (layout.num_pages, KV, layout.page_size)
                entry["k_scale"] = torch.zeros(sshape, dtype=torch.float32, device=dev)
                entry["v_scale"] = torch.zeros(sshape, dtype=torch.float32, device=dev)
            layers.append(entry)
        cache["groups"].append(layers)
    return cache


def _attn_prefill_kv(spec, p, xn, positions):
    B, S = xn.shape[:2]
    KV, D = spec.num_kv_heads, spec.head_dim
    k = qdot(xn, p["wk"]).reshape(B, S, KV, D)
    v = qdot(xn, p["wv"]).reshape(B, S, KV, D)
    k = L.rope(k, positions, spec.rope_theta)
    return k, v


# ---------------------------------------------------------------------------
# Prefill: forward + contiguous cache
# ---------------------------------------------------------------------------

def prefill(params, spec: ModelSpec, batch, *, max_seq: Optional[int] = None,
            impl: str = "naive",
            true_len=None) -> Tuple[torch.Tensor, Params]:
    """Run the prompt, return (last-position logits, contiguous cache of
    per-layer ``{"k", "v"}`` (B, max_seq, KV, D), zero-padded past S).
    With ``true_len`` the prompt is bucket-padded: logits come from
    position ``true_len - 1`` and ``cache["pos"]`` is ``true_len``.
    (The JAX version also lays out ring caches for the contiguous decode
    path, which is not ported.)"""
    x = _embed(params, spec, batch["tokens"])
    B, S = x.shape[:2]
    max_seq = max_seq or S
    positions = torch.arange(S, device=x.device)[None]
    groups = []
    for g, gp in zip(group_plan(spec), params["groups"]):
        base = _check_dense(g.kind)
        layers = []
        for p in gp:
            k, v = _attn_prefill_kv(spec, p, L.norm(spec, p, "norm1", x),
                                    positions)
            x = _layer_forward(spec, g.kind, p, x, positions, impl)
            pad = max_seq - S
            k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
            v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
            layers.append({"k": k, "v": v})
        groups.append(layers)
    if true_len is None:
        x_last = x[:, -1:]
    else:
        t = int(true_len)
        x_last = x[:, t - 1:t]
    logits = _lm_head(params, spec, x_last)
    pos = S if true_len is None else int(true_len)
    return logits, {"pos": torch.tensor(pos, dtype=torch.int32,
                                        device=x.device), "groups": groups}


# ---------------------------------------------------------------------------
# Paged decode / suffix prefill
# ---------------------------------------------------------------------------

def _scatter_kv_rows(kv: Dict, name: str, rows: torch.Tensor,
                     tgt_page: torch.Tensor, tgt_off: torch.Tensor) -> None:
    """Scatter float KV ``rows`` (N, KV, D) into one layer's pool at token
    positions (``tgt_page``, ``tgt_off``) (N,), quantizing per the pool's
    layout — in place.  A token's scales land at ``[page, :, off]``.

    int4 pools nibble-pack two adjacent tokens per byte, so a token write
    is a read-modify-write of its byte that keeps the neighbour's nibble.
    Writes run in two parity passes (even offsets, then odd) so the bytes
    touched within a pass are distinct; the only duplicate targets are
    rows routed to the null page, whose content is never read.
    """
    pool = kv[name + "_pages"]
    quant = _paged_quant(kv)
    tgt_page = tgt_page.long()
    tgt_off = tgt_off.long()
    if quant == "none":
        pool[tgt_page, tgt_off] = rows.to(pool.dtype)
        return
    if quant == "int8":
        qrow, srow = quantize_kv_int8(rows)
        pool[tgt_page, tgt_off] = qrow
        kv[name + "_scale"][tgt_page, :, tgt_off] = srow[..., 0]
        return
    qrow, srow = quantize_kv_int4(rows)
    nib = qrow.to(torch.int32) & 0x0F
    byte = tgt_off // 2
    expand = (slice(None),) + (None,) * (rows.ndim - 1)
    for parity in (0, 1):
        m = (tgt_off % 2) == parity
        tp = torch.where(m, tgt_page, torch.zeros_like(tgt_page))  # park on null
        cur = pool[tp, byte]
        c32 = cur.to(torch.int32)
        upd = ((c32 & 0xF0) | nib if parity == 0
               else (c32 & 0x0F) | (nib << 4))
        pool[tp, byte] = torch.where(m[expand], to_int8_wrapping(upd), cur)
    kv[name + "_scale"][tgt_page, :, tgt_off] = srow[..., 0]


def _attn_decode_paged(spec, p, x, pos, kv, block_tables, *, kind,
                       impl="auto") -> torch.Tensor:
    """Paged-cache decode attention for one layer: write the new k/v row
    at each slot's position ``pos`` (B,), then attend over the slot's
    block table with the paged attention op (the CUDA kernel on a CUDA
    tensor).  Flat block tables only: the ring layout of sliding-window
    stacks is not ported yet (ROADMAP queue 1 item 2)."""
    B = x.shape[0]
    H, KV, D = spec.num_heads, spec.num_kv_heads, spec.head_dim
    page = kv["k_scale"].shape[-1] if "k_scale" in kv else kv["k_pages"].shape[1]
    q = qdot(x, p["wq"], impl=impl).reshape(B, 1, H, D)
    k = qdot(x, p["wk"], impl=impl).reshape(B, 1, KV, D)
    v = qdot(x, p["wv"], impl=impl).reshape(B, 1, KV, D)
    posb = pos[:, None]
    q = L.rope(q, posb, spec.rope_theta)
    k = L.rope(k, posb, spec.rope_theta)

    # an out-of-range entry clamps to the last one, as a JAX gather does
    pidx = torch.clamp(pos.long() // page, max=block_tables.shape[1] - 1)
    slot_page = block_tables[torch.arange(B, device=x.device), pidx]
    off = pos.long() % page
    for name, row in (("k", k[:, 0]), ("v", v[:, 0])):
        _scatter_kv_rows(kv, name, row, slot_page, off)

    window = spec.sliding_window if kind == "attn_local" else 0
    o = kops.paged_attention(
        q[:, 0].contiguous(), kv["k_pages"], kv["v_pages"], block_tables,
        pos + 1, window=window, k_scale=kv.get("k_scale"),
        v_scale=kv.get("v_scale"), impl=impl)
    return qdot(o.reshape(B, 1, H * D), p["wo"], impl=impl)


def _suffix_attn_paged(spec, p, xn, positions, kv, pref_pages, prefix_len,
                       tgt_page, tgt_off, *, kind) -> torch.Tensor:
    """Attention for a prompt SUFFIX against cached prefix pages: gather
    the prefix K/V rows (dequantizing int8, unpacking int4), attend
    causally over [prefix ; suffix], and scatter the suffix K/V into the
    slot's own pages.  Padded rows go to the null page via ``tgt_page``."""
    B, S = xn.shape[:2]
    H, KV, D = spec.num_heads, spec.num_kv_heads, spec.head_dim
    quant = _paged_quant(kv)
    page = kv["k_scale"].shape[-1] if quant != "none" else kv["k_pages"].shape[1]
    npr = pref_pages.shape[0] * page
    q = qdot(xn, p["wq"]).reshape(B, S, H, D)
    k = qdot(xn, p["wk"]).reshape(B, S, KV, D)
    v = qdot(xn, p["wv"]).reshape(B, S, KV, D)
    q = L.rope(q, positions, spec.rope_theta)
    k = L.rope(k, positions, spec.rope_theta)

    pp = pref_pages.long()
    kp = kv["k_pages"][pp]                               # (n, page, KV, D)
    vp = kv["v_pages"][pp]
    if quant == "int4":
        kp = unpack_int4(kp, axis=1)
        vp = unpack_int4(vp, axis=1)
    kp = kp.to(torch.float32)
    vp = vp.to(torch.float32)
    if quant != "none":
        kp = kp * torch.movedim(kv["k_scale"][pp], -1, -2)[..., None]
        vp = vp * torch.movedim(kv["v_scale"][pp], -1, -2)[..., None]
    kp = kp.reshape(1, npr, KV, D)
    vp = vp.reshape(1, npr, KV, D)
    k_all = torch.cat([kp.to(k.dtype), k], dim=1)
    v_all = torch.cat([vp.to(v.dtype), v], dim=1)

    s = L.grouped_scores(q, k_all) / math.sqrt(D)        # (B,KV,G,S,T)
    if spec.attn_logit_softcap:
        s = torch.tanh(s / spec.attn_logit_softcap) * spec.attn_logit_softcap
    i_abs = positions[0][:, None]                        # (S, 1)
    k_abs = torch.cat([torch.arange(npr, device=xn.device), positions[0]])
    is_suffix = torch.cat([torch.zeros(npr, dtype=torch.bool, device=xn.device),
                           torch.ones(S, dtype=torch.bool, device=xn.device)])
    valid = (k_abs[None, :] >= 0) & (k_abs[None, :] <= i_abs) & \
            ((k_abs[None, :] < prefix_len) | is_suffix[None, :])
    window = spec.sliding_window if kind == "attn_local" else 0
    if window:
        valid &= (i_abs - k_abs[None, :]) < window
    s = torch.where(valid[None, None, None], s, torch.full_like(s, L.NEG_INF))
    prob = torch.softmax(s, dim=-1)
    o = L.grouped_out(prob, v_all).to(q.dtype)
    out = qdot(o.reshape(B, S, H * D), p["wo"])

    for name, rows in (("k", k[0]), ("v", v[0])):        # rows: (S, KV, D)
        _scatter_kv_rows(kv, name, rows, tgt_page, tgt_off)
    return out


def prefill_paged(params, spec: ModelSpec, tokens, cache, slot: int, bt_row,
                  prefix_len: int, true_len: int, *,
                  n_prefix_pages: int) -> Tuple[torch.Tensor, Params]:
    """Prefill a prompt SUFFIX into a paged slot whose first ``prefix_len``
    tokens are already cached.  ``tokens`` (1, S) is the bucket-padded
    suffix, ``true_len`` its real length, ``n_prefix_pages`` how many
    block-table entries to gather for the prefix (rows past
    ``prefix_len`` are masked).  Returns the logits of the last true
    suffix token; sets ``pos[slot]`` and the slot's block-table row."""
    page = paged_page_size(cache)
    dev = tokens.device
    S = tokens.shape[1]
    prefix_len, true_len = int(prefix_len), int(true_len)
    ar = torch.arange(S, device=dev)
    positions = (prefix_len + ar)[None]                  # (1, S) absolute
    pref_pages = bt_row[:n_prefix_pages]
    abs_pos = prefix_len + ar
    page_idx = torch.clamp(abs_pos // page, max=bt_row.shape[0] - 1)
    tgt_page = torch.where(ar < true_len, bt_row[page_idx].long(),
                           torch.zeros_like(page_idx))
    tgt_off = abs_pos % page

    x = _embed(params, spec, tokens)
    for g, gp, cg in zip(group_plan(spec), params["groups"], cache["groups"]):
        base = _check_dense(g.kind)
        for p, kv in zip(gp, cg):
            xn = L.norm(spec, p, "norm1", x)
            h = _suffix_attn_paged(spec, p, xn, positions, kv, pref_pages,
                                   prefix_len, tgt_page, tgt_off, kind=base)
            y = x + h
            x = y + L.mlp_block(spec, p, L.norm(spec, p, "norm2", y))
    logits = _lm_head(params, spec, x[:, true_len - 1:true_len])
    cache["pos"][slot] = prefix_len + true_len
    cache["block_tables"][slot] = bt_row
    return logits, cache


def decode_step_paged(params, spec: ModelSpec, cache, tokens, *,
                      impl: str = "auto") -> Tuple[torch.Tensor, Params]:
    """One decode step over a PAGED cache (per-slot positions): tokens
    (B, 1) -> logits (B, 1, V); every layer's attention reads and writes
    through the block tables, and ``pos`` advances by one.  ``impl`` is
    handed to the kernels' dispatch; the serving path leaves it at
    ``"auto"`` and only kernel-vs-plain checks pass ``"plain"``."""
    pos = cache["pos"]
    bt = cache["block_tables"]
    x = _embed(params, spec, tokens)
    for g, gp, cg in zip(group_plan(spec), params["groups"], cache["groups"]):
        base = _check_dense(g.kind)
        for p, kv in zip(gp, cg):
            xn = L.norm(spec, p, "norm1", x)
            h = _attn_decode_paged(spec, p, xn, pos, kv, bt, kind=base,
                                   impl=impl)
            y = x + h
            x = y + L.mlp_block(spec, p, L.norm(spec, p, "norm2", y),
                                impl=impl)
    logits = _lm_head(params, spec, x, impl=impl)
    cache["pos"] = pos + 1
    return logits, cache
