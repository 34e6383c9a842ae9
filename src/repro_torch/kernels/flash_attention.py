"""Flash-attention forward: the hand-written CUDA kernel
(``csrc/flash_attention.cu``) and its plain PyTorch version.

q (B, Sq, H, D) against k/v (B, Sk, KV, D) -> (B, Sq, H, D), float32.
Query positions are end-aligned (query i sits at ``i + Sk - Sq``), the
masks are causal and, with ``window > 0``, ``query - key < window``; GQA
maps query head h to KV head ``h // (H // KV)``.  A row with no valid
key returns zeros.  The kernel applies no logit softcap, as the TPU
kernel; the plain version takes one (``softcap``) so that it also
serves as the model's plain attention, ``models.layers.sdpa``.

The kernel replaces ``repro/kernels/flash_attention.py:_flash_kernel``
and takes any Sq and Sk (the TPU kernel needs multiples of 128) at the
models' head dims 64, 128 and 256; the
plain version is ``repro/kernels/ref.py:flash_attention_ref`` but for
fully masked rows, where the reference's softmax averages every value
row and this version returns zeros, as the kernels do.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30

#: Launches of the CUDA kernel (one per call that reaches it, though a
#: call whose long query tiles have their keys cut into chunks launches
#: the kernel and its merge pass).
LAUNCHES = 0


def attention_mask(Sq: int, Sk: int, *, causal: bool, window: int,
                   device=None) -> torch.Tensor:
    """(Sq, Sk) bool mask with end-aligned query positions."""
    q_idx = torch.arange(Sq, device=device)[:, None] + (Sk - Sq)
    k_idx = torch.arange(Sk, device=device)[None, :]
    m = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        m &= q_idx >= k_idx
    if window:
        m &= (q_idx - k_idx) < window
    return m


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          scale: Optional[float] = None,
                          softcap: float = 0.0) -> torch.Tensor:
    """Full-materialization grouped attention with the kernel's masks;
    ``softcap > 0`` caps the scaled logits at ``softcap * tanh(s /
    softcap)`` (the kernel has no softcap)."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    sc = scale if scale is not None else 1.0 / (D ** 0.5)
    qg = q.reshape(B, Sq, KV, H // KV, D).to(torch.float32)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k.to(torch.float32)) * sc
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    vm = attention_mask(Sq, Sk, causal=causal, window=window,
                        device=q.device)
    s = torch.where(vm, s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)
    e = torch.exp(s - m) * vm
    l = torch.sum(e, dim=-1, keepdim=True)
    p = e / torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bkgqt,btkd->bqkgd", p, v.to(torch.float32))
    return out.reshape(B, Sq, H, D).to(q.dtype)


def _lib():
    lib = _build.load("flash_attention")
    fn, chunks = lib.flash_attention_fwd, lib.flash_attention_chunks
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p,                 # q k v out part_o part_ml
                       i, i, i, i, i, i, i, i, i,        # B Sq Sk H KV D causal window chunks
                       ctypes.c_float, p]                # scale, stream
        fn.restype = ctypes.c_int
        chunks.argtypes = [i] * 5                        # Sq Sk D causal window
        chunks.restype = ctypes.c_int
    return fn, chunks


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention_cuda: {msg}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream (no sync)."""
    global LAUNCHES
    for t in (q, k, v):
        _check(t.is_cuda and t.device == q.device,
               f"all tensors must be on {q.device} (CUDA), got {t.device}")
        _check(t.dtype == torch.float32, f"tensors must be float32, got {t.dtype}")
    _check(q.ndim == 4 and k.ndim == 4 and tuple(k.shape) == tuple(v.shape),
           f"q (B, Sq, H, D), k/v (B, Sk, KV, D); got {tuple(q.shape)}, "
           f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    _, Sk, KV, Dk = k.shape
    _check(k.shape[0] == B and Dk == D and H % KV == 0,
           f"q {tuple(q.shape)} vs k/v {tuple(k.shape)}")
    _check(D in (64, 128, 256), f"head dim {D} (the kernel takes 64, 128, 256)")
    # the projections arrive as views of (B, S, H*D) rows: make them dense
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    sc = scale if scale is not None else 1.0 / (D ** 0.5)
    out = torch.empty_like(q)
    fwd, chunks = _lib()
    # the most key chunks a query tile is cut into; each chunk's (o, m, l)
    # per query row goes to scratch for the merge pass
    n_chunks = chunks(Sq, Sk, D, int(bool(causal)), int(window))
    part_o = part_ml = None
    if n_chunks > 1:
        part_o = torch.empty((B, H, Sq, n_chunks, D), dtype=torch.float32,
                             device=q.device)
        part_ml = torch.empty((B, H, Sq, n_chunks, 2), dtype=torch.float32,
                              device=q.device)
    ptr = [ctypes.c_void_p(t.data_ptr() if t is not None else 0)
           for t in (q, k, v, out, part_o, part_ml)]
    err = fwd(*ptr, B, Sq, Sk, H, KV, D, int(bool(causal)), int(window),
              n_chunks, float(sc),
              ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    _build.check(err, "flash_attention_fwd launch")
    LAUNCHES += 1
    return out
