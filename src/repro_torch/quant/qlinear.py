"""Quantized linear application + weight quantization for serving
(ported from ``repro.quant.qlinear``).

``quantize_params`` walks a parameter tree and converts matmul weights
to ``QuantizedTensor`` (per-channel INT8 or group-32 INT4 symmetric);
norms and embeddings stay float.  ``qdot`` applies ``x @ W`` for float
or quantized W: a quantized W goes to the dequantizing matmul (the CUDA
kernel on a CUDA tensor, at any M, K and N), a float W to
``torch.matmul``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.quant.qtypes import (QuantConfig, QuantizedTensor,
                                      W4_SYM_GROUP, W8_SYM_CHANNEL)
from repro_torch.quant.quantize import dequantize, quantize

# param-name substrings that stay float (norms, router, biases, embeddings)
_SKIP_SUBSTR = ("norm", "bias", "gate", "scale", "embed", "router", "conv")


def weight_cfg(precision: str) -> Optional[QuantConfig]:
    return {"int8": W8_SYM_CHANNEL, "int4": W4_SYM_GROUP}.get(precision)


def _quantizable(name: str, x) -> bool:
    if not isinstance(x, torch.Tensor) or x.ndim < 2:
        return False
    low = name.lower()
    return not any(s in low for s in _SKIP_SUBSTR)


def quantize_params(params: Dict[str, Any], precision: str) -> Dict[str, Any]:
    """Weight-only quantization of a (possibly nested) param tree.  Group
    int4 needs the contraction dim divisible by 2 * group (pack + group);
    other weights stay float, as in the JAX package."""
    cfg = weight_cfg(precision)
    if cfg is None:
        return params
    div = cfg.group_size * 2 if cfg.bits == 4 else 1

    def walk(prefix: str, tree):
        if isinstance(tree, dict):
            return {k: walk(f"{prefix}/{k}", v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(f"{prefix}/{i}", v) for i, v in enumerate(tree))
        if _quantizable(prefix, tree):
            if tree.ndim != 2:
                raise NotImplementedError(
                    f"{prefix}: only per-layer 2-D weights are quantized")
            if tree.shape[0] % div:
                return tree              # leave non-divisible weights float
            return quantize(tree, cfg)
        return tree

    return walk("", params)


def qdot(x: torch.Tensor, w, *, impl: str = "auto") -> torch.Tensor:
    """x @ w where w is a float tensor or a QuantizedTensor; leading dims
    of x collapse to one matmul."""
    if not isinstance(w, QuantizedTensor):
        return torch.matmul(x, w.to(x.dtype))
    lead = x.shape[:-1]
    K = x.shape[-1]
    out = kops.quant_matmul(x.reshape(-1, K).contiguous(), w, impl=impl)
    return out.reshape(*lead, w.shape[1])


def dequant_param(w):
    return dequantize(w) if isinstance(w, QuantizedTensor) else w
