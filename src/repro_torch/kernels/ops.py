"""Dispatch for the kernels: a CPU tensor takes the plain PyTorch
version, a CUDA tensor launches the hand-written kernel (or raises if
the library cannot be built or loaded).  ``impl="plain"`` exists so
that tests and ``chip_smoke.py`` can hold a kernel against its plain
version on the card; nothing on the serving path passes it.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import quant_matmul as _qmm
from repro_torch.quant.qtypes import QuantizedTensor

_IMPLS = ("auto", "plain")


def _use_plain(t: torch.Tensor, impl: str) -> bool:
    if impl not in _IMPLS:
        raise ValueError(f"impl {impl!r} (want one of {_IMPLS})")
    return impl == "plain" or t.device.type == "cpu"


def paged_attention(q, k_pages, v_pages, block_tables, lengths, *,
                    window: int = 0, ring: bool = False,
                    scale: Optional[float] = None, k_scale=None,
                    v_scale=None, impl: str = "auto") -> torch.Tensor:
    """Paged decode attention, q (B, H, D) -> (B, H, D); see
    ``kernels.paged_attention``."""
    fn = (_pa.paged_attention_plain if _use_plain(q, impl)
          else _pa.paged_attention_cuda)
    return fn(q, k_pages, v_pages, block_tables, lengths, window=window,
              ring=ring, scale=scale, k_scale=k_scale, v_scale=v_scale)


def _weight_operands(w: QuantizedTensor):
    """(wq, scale, bits, group) of a symmetric 2-D quantized weight in the
    layout the kernel takes: channel scales (N,), group scales
    (K/group, N); a per-tensor scale is broadcast to every channel."""
    cfg = w.config
    if w.zero is not None:
        raise NotImplementedError(
            "asymmetric weights have no kernel; serving quantizes weights "
            "symmetrically")
    K, N = w.shape
    if cfg.granularity == "group":
        group = cfg.group_size
        scale = w.scale.reshape(K // group, N)
    elif cfg.granularity == "channel":
        group = 0
        scale = w.scale.reshape(N)
    else:
        group = 0
        scale = w.scale.reshape(1).expand(N)
    return w.q, scale.contiguous(), cfg.bits, group


def quant_matmul(x: torch.Tensor, w: QuantizedTensor, *,
                 impl: str = "auto") -> torch.Tensor:
    """x (M, K) @ dequant(w) (K, N) -> (M, N), accumulated in f32."""
    wq, scale, bits, group = _weight_operands(w)
    fn = (_qmm.quant_matmul_plain if _use_plain(x, impl)
          else _qmm.quant_matmul_cuda)
    return fn(x, wq, scale, bits=bits, group=group)


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel."""
    return {"paged_attention": _pa.LAUNCHES, "quant_matmul": _qmm.LAUNCHES}


def reset_launch_counts() -> None:
    _pa.LAUNCHES = 0
    _qmm.LAUNCHES = 0
