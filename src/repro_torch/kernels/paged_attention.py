"""Paged decode attention: the hand-written CUDA kernel
(``csrc/paged_attention.cu``) and its plain PyTorch version.

One query token per slot, q (B, H, D), or a K-token decode window per
slot, q (B, K, H, D) (the speculative verify step), against page pools
shared through per-slot block tables:

* fp32 pools (P, page, KV, D);
* int8 pools (P, page, KV, D) with per-token f32 scales (P, KV, page);
* int4 pools nibble-packed along tokens (P, page/2, KV, D), low nibble =
  even token, with the same scales.

GQA folds H = KV * G query heads onto KV heads; ``lengths`` counts each
slot's valid context including the query tokens' own K/V (already
written), and a slot of length 0 returns zeros.  Query j of a K-token
window sits at absolute position ``length - K + j`` and attends the
keys at positions ``<= length - K + j`` (a single query is the case
K = 1).  ``window > 0`` also requires ``query position - tok < window``;
``ring=True`` declares each block-table row a ring of R entries (entry
j holds absolute page ``last - ((last - j) mod R)``, never-written
entries masked).

The kernel replaces ``repro/kernels/paged_attention.py:_paged_kernel``
(q (B, H, D), launched as a window of K = 1) and ``_paged_window_kernel``
(q (B, K, H, D)); the two wrappers count their launches apart (one per
call, though a call with more than one split launches the kernel and its
merge pass).  The plain version is the gather oracle of
``repro/kernels/ref.py`` (``paged_attention_ref`` and
``paged_attention_window_ref``).

The kernel splits each slot's block-table walk into runs of
``split_pages(page, D)`` entries, one grid block each, and merges a slot's
splits in ascending order.  The partition (``split_plan``) depends on a
slot's own length and table alone, never on the other slots of the
batch, so a slot's output is bitwise the same alone and in any batch.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.quant.quantize import unpack_int4

NEG_INF = -1e30
_QUANT_CODES = {"none": 0, "int8": 1, "int4": 2}

#: Launches of the CUDA kernel for a single query per slot.
LAUNCHES = 0
#: Launches of the CUDA kernel for a K-token window.
WINDOW_LAUNCHES = 0


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


def split_pages(page: int, D: int) -> int:
    """Block-table entries per split of the kernel's grid: 16 tokens of
    the pool at head dims up to 64, 32 above (at least one page).  A
    function of the page size and head dim alone, so that no slot's
    partition follows the batch."""
    return max(1, (16 if D <= 64 else 32) // page)


def n_splits(n_entries: int, page: int, D: int) -> int:
    """Splits in the kernel's grid for tables of ``n_entries`` entries."""
    return -(-n_entries // split_pages(page, D))


def split_plan(lengths: Sequence[int], n_entries: int, page: int, D: int,
               *, K: int = 1, window: int = 0, ring: bool = False
               ) -> List[List[Tuple[int, List[int]]]]:
    """The kernel's partition of each slot's walk, as (split index, the
    block-table entries that split visits) per slot, in the order the
    merge pass takes them.  It mirrors ``slot_walk`` and ``next_entry`` of
    ``csrc/paged_attention.cu``: only the entries holding a key some of
    the slot's K queries may see, in runs of ``split_pages(page, D)``
    entries counted from entry 0."""
    pps = split_pages(page, D)
    plans = []
    for length in lengths:
        length = int(length)
        last = (length - 1) // page if length > 0 else 0
        lo_valid = length - K - window + 1 if window > 0 else 0
        if length <= 0:
            e_begin = e_end = 0
        elif ring:
            e_begin, e_end = 0, n_entries
        else:
            e_begin = max(lo_valid, 0) // page
            e_end = min(last, n_entries - 1) + 1
        plan = []
        for s in range(e_begin // pps, -(-e_end // pps)):
            entries = []
            for e in range(max(s * pps, e_begin), min((s + 1) * pps, e_end)):
                ap = last - ((last - e) % n_entries) if ring else e
                t0 = ap * page
                if ap >= 0 and t0 <= length - 1 and t0 + page - 1 >= lo_valid:
                    entries.append(e)
            plan.append((s, entries))
        plans.append(plan)
    return plans


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
    """Gather-based paged attention in plain tensor ops: gather every
    block-table page, dequantize, mask, softmax.  q (B, H, D) or a
    K-token window (B, K, H, D); the output has q's shape."""
    single = q.ndim == 3
    q4 = q[:, None] if single else q
    B, K, H, D = q4.shape
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
    qg = q4.reshape(B, K, KV, G, D).to(torch.float32) * sc
    s = torch.einsum("bjkgd,btkd->bjkgt", qg, k)      # (B, K, KV, G, S)
    lengths = lengths.long()
    q_abs = (lengths[:, None] - K
             + torch.arange(K, device=q.device)[None])[..., None]  # (B, K, 1)
    if ring:
        idx = _ring_positions(lengths, bt.shape[1], page)[:, None]
        valid = (idx >= 0) & (idx <= q_abs)                        # (B, K, S)
    else:
        idx = torch.arange(S, device=q.device)[None, None]
        valid = idx <= q_abs
    if window:
        valid = valid & ((q_abs - idx) < window)
    vm = valid[:, :, None, None]
    s = torch.where(vm, s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)
    e = torch.exp(s - m) * vm
    l = torch.sum(e, dim=-1, keepdim=True)
    p = e / torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bjkgt,btkd->bjkgd", p, v).reshape(B, K, H, D)
    return (out[:, 0] if single else out).to(q.dtype)


def _lib():
    fn = _build.load("paged_attention").paged_attention
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        # 10 tensors; B H KV D page n quant K window ring pps; scale; stream
        fn.argtypes = [p] * 10 + [i] * 11 + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention_cuda: {msg}")


def _launch(q, k_pages, v_pages, block_tables, lengths, window, ring, scale,
            k_scale, v_scale) -> torch.Tensor:
    """Check the operands and launch the kernel on PyTorch's current
    stream (no sync).  ``q`` is (B, K, H, D)."""
    quant, page = _pool_quant(k_pages, k_scale)
    B, K, H, D = q.shape
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
    # 16-byte copies of page rows; one register slice per lane of D
    _check(D % 16 == 0 and D <= 256,
           f"head dim {D} (the kernel takes multiples of 16 up to 256)")
    _check(quant == "none" or page % 4 == 0,
           f"quantized pages of {page} tokens (want a multiple of 4)")
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
    n_entries = block_tables.shape[1]
    S = n_splits(n_entries, page, D)
    # the merge pass stages each split's (m, l) in 48 KB of shared memory
    _check(S <= 6144, f"{n_entries} table entries ({S} splits, at most 6144)")
    if S > 1:   # each split's (acc, m, l) per query row, for the merge pass
        part_acc = torch.empty((B, KV, S, K * (H // KV), D),
                               dtype=torch.float32, device=q.device)
        part_ml = torch.empty((B, KV, S, K * (H // KV), 2),
                              dtype=torch.float32, device=q.device)
    err = _lib()(
        _ptr(q), _ptr(k_pages), _ptr(v_pages),
        _ptr(k_scale) if quant != "none" else null,
        _ptr(v_scale) if quant != "none" else null,
        _ptr(block_tables), _ptr(lengths), _ptr(out),
        _ptr(part_acc) if S > 1 else null, _ptr(part_ml) if S > 1 else null,
        B, H, KV, D, page, n_entries, _QUANT_CODES[quant], K,
        int(window), int(bool(ring)), split_pages(page, D), float(sc),
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    _build.check(err, "paged_attention launch")
    return out


def paged_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, block_tables: torch.Tensor,
                         lengths: torch.Tensor, *, window: int = 0,
                         ring: bool = False, scale: Optional[float] = None,
                         k_scale: Optional[torch.Tensor] = None,
                         v_scale: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Launch the CUDA kernel for a single query per slot, q (B, H, D)
    (a window of K = 1)."""
    global LAUNCHES
    _check(q.ndim == 3, f"q must be (B, H, D), got {tuple(q.shape)}")
    out = _launch(q[:, None], k_pages, v_pages, block_tables, lengths, window,
                  ring, scale, k_scale, v_scale)
    LAUNCHES += 1
    return out[:, 0]


def paged_attention_window_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor,
                                block_tables: torch.Tensor,
                                lengths: torch.Tensor, *, window: int = 0,
                                ring: bool = False,
                                scale: Optional[float] = None,
                                k_scale: Optional[torch.Tensor] = None,
                                v_scale: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """Launch the CUDA kernel for a K-token window, q (B, K, H, D)."""
    global WINDOW_LAUNCHES
    _check(q.ndim == 4 and q.shape[1] >= 1,
           f"q must be (B, K, H, D), got {tuple(q.shape)}")
    out = _launch(q, k_pages, v_pages, block_tables, lengths, window, ring,
                  scale, k_scale, v_scale)
    WINDOW_LAUNCHES += 1
    return out
