"""Parameter and cache exchange with the JAX package, through numpy.

``params_from_jax`` takes the JAX ``lm.init`` tree after
``jax.tree_util.tree_map(np.asarray, ...)`` and returns the port's
params: per-layer tensors where JAX stacks ``(L, ...)`` leaves.  A
quantized leaf is recognised by duck typing (``.q``, ``.scale``,
``.zero``, ``.config.bits/granularity/group_size/symmetric``), so this
module needs neither JAX nor the JAX package.  Quantized bytes pass
through unchanged.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.quant.qtypes import QuantConfig, QuantizedTensor


def _is_quantized(x) -> bool:
    cfg = getattr(x, "config", None)
    return (all(hasattr(x, a) for a in ("q", "scale", "zero"))
            and all(hasattr(cfg, a) for a in
                    ("bits", "granularity", "group_size", "symmetric")))


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _config(cfg) -> QuantConfig:
    return QuantConfig(bits=int(cfg.bits), symmetric=bool(cfg.symmetric),
                       granularity=str(cfg.granularity),
                       group_size=int(cfg.group_size),
                       axis=int(getattr(cfg, "axis", -1)))


def _leaf(x, device, index=None):
    """One leaf (optionally layer ``index`` of a stacked leaf) as a
    tensor or a port ``QuantizedTensor``."""
    pick = (lambda a: a) if index is None else (lambda a: np.asarray(a)[index])
    if _is_quantized(x):
        return QuantizedTensor(
            q=_tensor(pick(x.q), device), scale=_tensor(pick(x.scale), device),
            zero=None if x.zero is None else _tensor(pick(x.zero), device),
            config=_config(x.config))
    return _tensor(pick(x), device)


def _n_layers(x) -> int:
    return int(np.asarray(x.q if _is_quantized(x) else x).shape[0])


def params_from_jax(tree: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """JAX params ``{"global": {...}, "groups": [{name: (L, ...)}]}`` ->
    port params ``{"global": {...}, "groups": [[{name: tensor}] * L]}``."""
    extra = set(tree) - {"global", "groups"}
    if extra:
        raise NotImplementedError(
            f"param subtrees {sorted(extra)} are not ported yet "
            "(ROADMAP queue 1 item 7)")
    out: Dict[str, Any] = {
        "global": {k: _leaf(v, device) for k, v in tree["global"].items()},
        "groups": []}
    for gp in tree["groups"]:
        n = {_n_layers(v) for v in gp.values()}
        if len(n) != 1:
            raise ValueError(f"group leaves disagree on layer count: {n}")
        out["groups"].append([{k: _leaf(v, device, i) for k, v in gp.items()}
                              for i in range(n.pop())])
    return out


def _numpy_leaf(x):
    if isinstance(x, QuantizedTensor):
        return {"q": x.q.cpu().numpy(), "scale": x.scale.cpu().numpy(),
                "zero": None if x.zero is None else x.zero.cpu().numpy()}
    return x.cpu().numpy()


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse layout as numpy: stacked ``(L, ...)`` group leaves; a
    quantized leaf becomes ``{"q", "scale", "zero"}`` arrays."""
    def stack(leaves):
        if isinstance(leaves[0], dict):
            return {k: (None if leaves[0][k] is None
                        else np.stack([l[k] for l in leaves]))
                    for k in leaves[0]}
        return np.stack(leaves)

    groups = []
    for layers in params["groups"]:
        np_layers = [{k: _numpy_leaf(v) for k, v in p.items()} for p in layers]
        groups.append({k: stack([p[k] for p in np_layers])
                       for k in np_layers[0]})
    return {"global": {k: _numpy_leaf(v) for k, v in params["global"].items()},
            "groups": groups}


def cache_from_jax(cache: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """A JAX paged cache (numpy leaves) -> the port's cache: the same
    dict/list structure with tensors, so both packages can step from one
    state."""
    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [walk(v) for v in x]
        return _tensor(x, device)
    return walk(cache)
