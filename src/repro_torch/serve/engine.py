"""Static-batching serving engine: prefill + batched greedy/sampled decode
(the port of ``repro.serve.engine``).

One ``generate()`` call prefills a fixed batch of equal-length prompts
into a contiguous cache (``models.lm.prefill``) and decodes a fixed
number of steps with ``models.lm.decode_step``, in a Python loop: the
JAX package scans a jitted step, PyTorch runs the same steps eagerly.
Weight-only INT8/INT4 serving goes through ``load_quantized``; the
quantized projections then launch the dequantizing-matmul kernel on a
CUDA device, and ``attention_impl="pallas"`` sends the prefill attention
to the flash kernel.  The decode attention over the contiguous cache is
plain tensor math, as it is in the JAX package.

The continuous-batching engine over a paged cache is
``serve.scheduler.ContinuousBatchingEngine``.

Greedy decoding (``temperature=0``) gives the JAX engine's tokens.
Sampling (``temperature > 0``) draws from a ``torch.Generator``; its
numbers are not ``jax.random``'s.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from repro_torch.core.model_config import ModelSpec
from repro_torch.models import lm
from repro_torch.quant.qlinear import quantize_params


@dataclass
class ServeConfig:
    max_seq: int = 2048
    temperature: float = 0.0          # 0 = greedy
    weight_precision: str = "fp32"    # fp32 | int8 | int4
    cache_dtype: Any = None           # torch dtype of the contiguous cache
    attention_impl: str = "auto"


def load_quantized(params: Any, precision: str) -> Any:
    return quantize_params(params, precision)


def _sample(logits: torch.Tensor, temperature: float,
            generator: torch.Generator) -> torch.Tensor:
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def generate(params: Any, spec: ModelSpec, batch: Dict[str, torch.Tensor],
             num_steps: int, cfg: ServeConfig,
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
    """Prefill the prompt then decode ``num_steps`` tokens for the batch.
    Returns ``{"tokens": (B, num_steps + 1), "cache_pos"}``.  Sampling
    draws from ``generator`` (default: seeded 0 on the prompt's device,
    as the JAX engine defaults to ``PRNGKey(0)``)."""
    tokens = batch["tokens"]
    if generator is None:
        generator = torch.Generator(device=tokens.device).manual_seed(0)
    with torch.no_grad():
        logits, cache = lm.prefill(params, spec, batch, max_seq=cfg.max_seq,
                                   impl=cfg.attention_impl,
                                   cache_dtype=cfg.cache_dtype)
        tok = _sample(logits[:, 0], cfg.temperature, generator)
        out = [tok]
        for _ in range(num_steps):
            logits, cache = lm.decode_step(params, spec, cache, tok[:, None])
            tok = _sample(logits[:, 0], cfg.temperature, generator)
            out.append(tok)
    return {"tokens": torch.stack(out, dim=1)[:, :num_steps + 1],
            "cache_pos": cache["pos"]}


_GEN_CACHE: Dict[Any, Any] = {}


def jitted_generate(spec: ModelSpec, cfg: ServeConfig):
    """The ``generate`` closure, cached per (spec, cfg) as in the JAX
    package so callers share one function object per configuration.
    PyTorch runs it eagerly: nothing is traced or compiled.  Returns
    ``fn(params, batch, num_steps)``."""
    key = (spec, cfg.max_seq, cfg.temperature, cfg.weight_precision,
           str(cfg.cache_dtype), cfg.attention_impl)
    if key not in _GEN_CACHE:
        def fn(params, batch, num_steps):
            return generate(params, spec, batch, num_steps, cfg)
        _GEN_CACHE[key] = fn
    return _GEN_CACHE[key]


def make_serve_step(spec: ModelSpec):
    """One batched decode step: ``(params, cache, tokens) -> (logits,
    cache)``."""
    def serve_step(params, cache, tokens):
        return lm.decode_step(params, spec, cache, tokens)
    return serve_step


def make_prefill_step(spec: ModelSpec, max_seq: int, impl: str = "auto"):
    def prefill_step(params, batch):
        return lm.prefill(params, spec, batch, max_seq=max_seq, impl=impl)
    return prefill_step
