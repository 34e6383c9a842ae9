"""Dequantizing matmul ``x @ dequant(W)``: the hand-written CUDA kernel
(``csrc/quant_matmul.cu``) and its plain PyTorch version.

x (M, K) float32; W int8 (K, N) or int4 nibble-packed along K (K/2, N),
low nibble = even row; scales per channel (N) or per group (K/group, N);
symmetric only.  The result is accumulated in f32.

The kernel replaces ``repro/kernels/quant_matmul.py:_qmm_kernel``.  It
takes any M, K and N: the TPU kernel's 128-multiples were a tiling
constraint of that machine.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.quant.quantize import unpack_int4

#: Launches of the CUDA kernel (one per call that reaches it).
LAUNCHES = 0

_K_TILE = 64        # K rows per tile in the kernel; splits align to it
_SM_COUNT = 132     # H100 SXM


def dequant_weight(wq: torch.Tensor, scale: torch.Tensor, *, bits: int,
                   group: int) -> torch.Tensor:
    """(K[/2], N) int8 + scales -> f32 (K, N), as the JAX reference
    dequantizes: ``float(q) * scale`` per element."""
    w = unpack_int4(wq) if bits == 4 else wq
    wf = w.to(torch.float32)
    K, N = wf.shape
    if group:
        return (wf.reshape(K // group, group, N)
                * scale.reshape(K // group, 1, N)).reshape(K, N)
    return wf * scale.reshape(1, N)


def quant_matmul_plain(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                       *, bits: int = 8, group: int = 0) -> torch.Tensor:
    """Dequantize the weight, then an f32 matmul."""
    wf = dequant_weight(wq, scale, bits=bits, group=group)
    return torch.matmul(x.to(torch.float32), wf).to(x.dtype)


def _lib():
    fn = _build.load("quant_matmul").quant_matmul
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _splits(M: int, K: int, N: int, group: int):
    """K splits so the grid has about two blocks per SM; each split is a
    multiple of the K tile (and of the int4 group) so no split cuts a
    packed row pair or a scale group."""
    base = -(-N // 256) * -(-M // 8)
    align = _K_TILE
    if group and group > _K_TILE:
        align = group
    max_splits = max(1, K // align)
    want = max(1, min(max_splits, -(-2 * _SM_COUNT // base)))
    kps = -(-K // want)
    kps = -(-kps // align) * align
    return -(-K // kps), kps


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"quant_matmul_cuda: {msg}")


def quant_matmul_cuda(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                      *, bits: int = 8, group: int = 0) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream (no sync)."""
    global LAUNCHES
    for t in (x, wq, scale):
        _check(t.is_cuda and t.device == x.device,
               f"all tensors must be on {x.device} (CUDA), got {t.device}")
        _check(t.is_contiguous(), "tensors must be contiguous")
    _check(x.dtype == torch.float32 and x.ndim == 2,
           f"x must be float32 (M, K), got {x.dtype} {tuple(x.shape)}")
    _check(wq.dtype == torch.int8 and wq.ndim == 2, "wq must be int8 (K', N)")
    _check(scale.dtype == torch.float32, "scale must be float32")
    _check(bits in (4, 8), f"bits {bits}")
    M, K = x.shape
    N = wq.shape[1]
    _check(wq.shape[0] * (2 if bits == 4 else 1) == K,
           f"x {tuple(x.shape)} vs wq {tuple(wq.shape)} at {bits} bits")
    if group:
        _check(K % group == 0 and group % 2 == 0 and scale.numel() == K // group * N,
               f"group {group} scales {tuple(scale.shape)} for K={K}, N={N}")
    else:
        _check(scale.numel() == N, f"channel scales {tuple(scale.shape)} for N={N}")
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    splits, kps = _splits(M, K, N, group)
    ws = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    err = _lib()(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(wq.data_ptr()),
        ctypes.c_void_p(scale.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(ws.data_ptr() if ws is not None else 0),
        M, K, N, bits, group, splits, kps,
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    _build.check(err, "quant_matmul launch")
    LAUNCHES += 1
    return out
