"""Quantization configuration taxonomy (paper §II-A).

symmetric vs asymmetric x per-tensor vs per-channel vs per-group, at
8 or 4 bits.  Mirrors ``repro.quant.qtypes``; ``QuantizedTensor`` is a
plain dataclass of tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class QuantConfig:
    bits: int = 8                       # 8 or 4
    symmetric: bool = True              # eq. (1)/(2) vs eq. (3)/(4)
    granularity: str = "channel"        # tensor | channel | group
    group_size: int = 32                # for granularity == "group"
    axis: int = -1                      # channel axis (output features)

    def __post_init__(self):
        assert self.bits in (4, 8), "INT8/INT4 only (paper scope)"
        assert self.granularity in ("tensor", "channel", "group")

    @property
    def qmax(self) -> int:
        return (1 << (self.bits - 1)) - 1      # 127 / 7

    @property
    def qmin(self) -> int:
        return -(1 << (self.bits - 1))         # -128 / -8


# Common presets
W8_SYM_CHANNEL = QuantConfig(bits=8, symmetric=True, granularity="channel")
W4_SYM_GROUP = QuantConfig(bits=4, symmetric=True, granularity="group", group_size=32)
A8_ASYM_TENSOR = QuantConfig(bits=8, symmetric=False, granularity="tensor")
A8_SYM_TENSOR = QuantConfig(bits=8, symmetric=True, granularity="tensor")


@dataclass
class QuantizedTensor:
    """Dequantizable container: values (int8, nibble-packed along dim -2
    when bits == 4), scale, optional zero-point."""
    q: torch.Tensor
    scale: torch.Tensor
    zero: Optional[torch.Tensor]
    config: QuantConfig

    @property
    def shape(self) -> tuple:
        """Logical (unpacked) shape."""
        s = list(self.q.shape)
        if self.config.bits == 4:
            s[-2] *= 2
        return tuple(s)

    @property
    def ndim(self) -> int:
        return self.q.ndim

    def to(self, device) -> "QuantizedTensor":
        return QuantizedTensor(
            q=self.q.to(device), scale=self.scale.to(device),
            zero=None if self.zero is None else self.zero.to(device),
            config=self.config)
