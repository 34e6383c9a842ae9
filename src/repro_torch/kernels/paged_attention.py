"""Paged decode attention: the hand-written CUDA kernel
(``csrc/paged_attention.cu``) and its plain PyTorch version.

One query token per slot, q (B, H, D), against page pools shared through
per-slot block tables:

* fp32 pools (P, page, KV, D);
* int8 pools (P, page, KV, D) with per-token f32 scales (P, KV, page);
* int4 pools nibble-packed along tokens (P, page/2, KV, D), low nibble =
  even token, with the same scales.

GQA folds H = KV * G query heads onto KV heads; ``lengths`` counts each
slot's valid context (the current token's K/V already written) and a
slot of length 0 returns zeros.  ``window > 0`` keeps only keys with
``tok > length - 1 - window``; ``ring=True`` declares each block-table
row a ring of R entries (entry j holds absolute page
``last - ((last - j) mod R)``, never-written entries masked).

The kernel replaces ``repro/kernels/paged_attention.py:_paged_kernel``;
the plain version is the gather oracle of ``repro/kernels/ref.py``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.quant.quantize import unpack_int4

NEG_INF = -1e30
_QUANT_CODES = {"none": 0, "int8": 1, "int4": 2}

#: Launches of the CUDA kernel (one per call that reaches it).
LAUNCHES = 0

_WINDOW_TODO = ("the K-token verify window (4-D q) is not ported yet "
                "(ROADMAP queue 1 item 1)")


def _pool_quant(k_pages: torch.Tensor, k_scale: Optional[torch.Tensor]):
    """(quant, page) of a pool: int4 iff the value pool's token dim is
    half the scale pool's."""
    if k_scale is None:
        return "none", k_pages.shape[1]
    page = k_scale.shape[-1]
    if k_pages.shape[1] == page:
        return "int8", page
    if k_pages.shape[1] * 2 != page:
        raise ValueError(f"int4 pages {tuple(k_pages.shape)} do not pack "
                         f"scale token dim {page}")
    return "int4", page


def _ring_positions(lengths: torch.Tensor, n_entries: int,
                    page: int) -> torch.Tensor:
    """Per-slot absolute token positions (B, n_entries * page) of a ring
    block table (negative => entry never written)."""
    last = torch.clamp_min(lengths[:, None] - 1, 0) // page          # (B, 1)
    j = torch.arange(n_entries, device=lengths.device)[None]         # (1, R)
    ap = last - torch.remainder(last - j, n_entries)                 # (B, R)
    pos = ap[:, :, None] * page + torch.arange(page, device=lengths.device)
    return pos.reshape(lengths.shape[0], n_entries * page)


def paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, block_tables: torch.Tensor,
                          lengths: torch.Tensor, *, window: int = 0,
                          ring: bool = False, scale: Optional[float] = None,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Gather-based paged decode attention in plain tensor ops: gather
    every block-table page, dequantize, mask, softmax."""
    if q.ndim == 4:
        raise NotImplementedError(_WINDOW_TODO)
    B, H, D = q.shape
    KV = k_pages.shape[2]
    quant, page = _pool_quant(k_pages, k_scale)
    if quant == "int4":
        k_pages = unpack_int4(k_pages, axis=1)
        v_pages = unpack_int4(v_pages, axis=1)
    G = H // KV
    sc = scale if scale is not None else 1.0 / (D ** 0.5)
    bt = block_tables.long()
    k = k_pages[bt].to(torch.float32)                 # (B, n, page, KV, D)
    v = v_pages[bt].to(torch.float32)
    if k_scale is not None:
        k = k * torch.movedim(k_scale[bt], -1, -2)[..., None]
        v = v * torch.movedim(v_scale[bt], -1, -2)[..., None]
    S = bt.shape[1] * page
    k = k.reshape(B, S, KV, D)
    v = v.reshape(B, S, KV, D)
    qg = q.reshape(B, KV, G, D).to(torch.float32) * sc
    s = torch.einsum("bkgd,btkd->bkgt", qg, k)        # (B, KV, G, S)
    lengths = lengths.long()
    if ring:
        idx = _ring_positions(lengths, bt.shape[1], page)
        valid = (idx >= 0) & (idx < lengths[:, None])
    else:
        idx = torch.arange(S, device=q.device)[None].expand(B, S)
        valid = idx < lengths[:, None]
    if window:
        valid = valid & (idx > (lengths[:, None] - 1 - window))
    vm = valid[:, None, None]
    s = torch.where(vm, s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)
    e = torch.exp(s - m) * vm
    l = torch.sum(e, dim=-1, keepdim=True)
    p = e / torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bkgt,btkd->bkgd", p, v)
    return out.reshape(B, H, D).to(q.dtype)


def _lib():
    lib = _build.load("paged_attention")
    fn = lib.paged_attention_decode
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p,           # tensors
                       i, i, i, i, i, i, i, i, i,        # B H KV D page n quant window ring
                       ctypes.c_float, p]                # scale, stream
        fn.restype = ctypes.c_int
    return fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention_cuda: {msg}")


def paged_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, block_tables: torch.Tensor,
                         lengths: torch.Tensor, *, window: int = 0,
                         ring: bool = False, scale: Optional[float] = None,
                         k_scale: Optional[torch.Tensor] = None,
                         v_scale: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream (no sync)."""
    global LAUNCHES
    if q.ndim == 4:
        raise NotImplementedError(_WINDOW_TODO)
    quant, page = _pool_quant(k_pages, k_scale)
    B, H, D = q.shape
    P, _, KV, Dk = k_pages.shape
    tensors = [q, k_pages, v_pages, block_tables, lengths]
    if quant != "none":
        _check(v_scale is not None, "k_scale given without v_scale")
        tensors += [k_scale, v_scale]
    for t in tensors:
        _check(t.is_cuda and t.device == q.device,
               f"all tensors must be on {q.device} (CUDA), got {t.device}")
        _check(t.is_contiguous(), "tensors must be contiguous")
    _check(q.dtype == torch.float32, f"q must be float32, got {q.dtype}")
    want = torch.float32 if quant == "none" else torch.int8
    _check(k_pages.dtype == want and v_pages.dtype == want,
           f"{quant} pools must be {want}, got {k_pages.dtype}")
    _check(tuple(v_pages.shape) == tuple(k_pages.shape), "k/v pool shapes differ")
    _check(Dk == D and H % KV == 0, f"q {tuple(q.shape)} vs pools "
           f"{tuple(k_pages.shape)}")
    if quant != "none":
        for s in (k_scale, v_scale):
            _check(s.dtype == torch.float32 and tuple(s.shape) == (P, KV, page),
                   f"scales must be float32 (P, KV, page), got "
                   f"{s.dtype} {tuple(s.shape)}")
    _check(block_tables.dtype == torch.int32 and block_tables.ndim == 2
           and block_tables.shape[0] == B, "block_tables must be int32 (B, n)")
    _check(lengths.dtype == torch.int32 and tuple(lengths.shape) == (B,),
           "lengths must be int32 (B,)")
    sc = scale if scale is not None else 1.0 / (D ** 0.5)
    out = torch.empty_like(q)
    null = ctypes.c_void_p(0)
    err = _lib()(
        ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k_pages.data_ptr()),
        ctypes.c_void_p(v_pages.data_ptr()),
        ctypes.c_void_p(k_scale.data_ptr()) if quant != "none" else null,
        ctypes.c_void_p(v_scale.data_ptr()) if quant != "none" else null,
        ctypes.c_void_p(block_tables.data_ptr()),
        ctypes.c_void_p(lengths.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        B, H, KV, D, page, block_tables.shape[1], _QUANT_CODES[quant],
        int(window), int(bool(ring)), float(sc),
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    _build.check(err, "paged_attention_decode launch")
    LAUNCHES += 1
    return out
