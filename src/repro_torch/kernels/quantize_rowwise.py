"""Per-row symmetric quantization: the hand-written CUDA kernel
(``csrc/quantize_rowwise.cu``) and its plain PyTorch version.

x (M, K), cast to f32 -> q int8 (M, K) and scale f32 (M, 1), with
``scale = max(amax, 1e-8) / qmax`` per row and
``q = clip(round(x / scale), -qmax - 1, qmax)``; qmax is 127 for
``bits=8`` and 7 for ``bits=4`` (4-bit codes stay one per int8,
unpacked).  Rounding is half to even and ``x / scale`` a division, as in
the reference, so both versions give the reference's bytes.

The kernel replaces ``repro/kernels/quantize_kernel.py:_quantize_kernel``
and takes any M and K (the TPU kernel's 128-row blocks were a tiling of
that machine).  The plain version is
``repro/kernels/ref.py:quantize_rowwise_ref``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

#: Launches of the CUDA kernel (one per call that reaches it).
LAUNCHES = 0


def _qmax(bits: int) -> int:
    if bits not in (4, 8):
        raise ValueError(f"bits {bits} (want 4 or 8)")
    return (1 << (bits - 1)) - 1


def quantize_rowwise_plain(x: torch.Tensor, *, bits: int = 8
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (M, K) -> (q int8 (M, K), scale f32 (M, 1)) in plain tensor ops."""
    qmax = _qmax(bits)
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    # one IEEE division, as jnp and the kernel divide: on a CUDA tensor
    # PyTorch turns a division by a Python number into a multiply by its
    # rounded reciprocal, which can move a scale by one ulp
    scale = torch.clamp_min(amax, 1e-8) / torch.full_like(amax, qmax)
    q = torch.clamp(torch.round(xf / scale), -qmax - 1, qmax)
    return q.to(torch.int8), scale


def _lib():
    fn = _build.load("quantize_rowwise").quantize_rowwise
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, p]       # x q scale M K bits stream
        fn.restype = ctypes.c_int
    return fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"quantize_rowwise_cuda: {msg}")


def quantize_rowwise_cuda(x: torch.Tensor, *, bits: int = 8
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on PyTorch's current stream (no sync)."""
    global LAUNCHES
    _check(x.is_cuda, f"x must be on a CUDA device, got {x.device}")
    _check(x.ndim == 2, f"x must be (M, K), got {tuple(x.shape)}")
    _qmax(bits)
    x = x.to(torch.float32).contiguous()
    M, K = x.shape
    q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    scale = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    err = _lib()(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(q.data_ptr()),
        ctypes.c_void_p(scale.data_ptr()), M, K, bits,
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    _build.check(err, "quantize_rowwise launch")
    LAUNCHES += 1
    return q, scale
