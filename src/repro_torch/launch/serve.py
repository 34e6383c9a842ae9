"""Serving launcher of the port: static batched generation or the
continuous-batching paged engine, with optional weight quantization, on
one CUDA device (or the CPU when asked).

    python -m repro_torch.launch.serve --engine paged --arch tinyllama-1.1b \\
        --precision int4 --cache-dtype int8

runs the named model at its full width from seeded random weights
(``--local`` scales it down for a quick CPU run).  ``--engine static``
(the default, as in the JAX launcher) prefills ``--batch`` prompts of
``--prompt-len`` tokens and decodes ``--steps`` tokens with
``serve.engine.generate``; ``--engine paged`` submits ``--batch``
requests with prompts of ``--min-prompt-len``..``--prompt-len`` tokens
and ``--steps`` new tokens each to the scheduler and drains it.
``--precision`` quantizes the weights (int8 per channel, int4
group-32), ``--cache-dtype`` picks the KV page precision, ``--spec-k
K`` turns on self-speculative decoding (n-gram prompt-lookup drafts
verified K tokens per step; outputs stay greedy), and
``--sliding-window W`` overrides the spec's attention window: on a
uniformly ``attn_local`` stack (Gemma3 cut to at most its first five
layers with ``--local --layers``) the paged engine switches to ring
block tables, per-slot KV bounded at O(window) pages.  ``--devices > 1``
and ``--dp > 1`` are not ported yet and are refused.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.quant.qlinear import quantize_params


def _refuse(args) -> Optional[str]:
    if args.devices > 1:
        return "--devices > 1 is not ported yet (ROADMAP queue 1 item 6)"
    if args.dp > 1:
        return "--dp > 1 is not ported yet (ROADMAP queue 1 item 6)"
    return None


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=sorted(ARCHS))
    ap.add_argument("--local", action="store_true",
                    help="scale the model down (--layers/--width/--vocab)")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--batch", type=int, default=4, help="requests")
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="longest prompt (tokens)")
    ap.add_argument("--min-prompt-len", type=int, default=0,
                    help="shortest prompt (default: half of --prompt-len)")
    ap.add_argument("--steps", type=int, default=32,
                    help="new tokens per request")
    ap.add_argument("--precision", default="fp32",
                    choices=["fp32", "int8", "int4"])
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="static engine sampling temperature (0 = greedy)")
    ap.add_argument("--engine", default="static", choices=["static", "paged"],
                    help="static generate() vs the continuous-batching "
                         "paged scheduler")
    ap.add_argument("--cache-dtype", default="fp32",
                    choices=["fp32", "int8", "int4"],
                    help="paged KV page precision")
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--spec-k", type=int, default=1)
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill: per-iteration prefill token "
                         "budget (multiple of the page size; 0 = off)")
    ap.add_argument("--sliding-window", type=int, default=0,
                    help="override the spec's attention sliding window")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0,
                    help="weight seed (sampling uses seed + 1)")
    return ap


def _prompts(args, spec, lo: int):
    """``--batch`` prompts of ``lo``..``--prompt-len`` tokens from seed 1."""
    rng = np.random.default_rng(1)
    return [rng.integers(0, spec.vocab_size,
                         size=int(rng.integers(lo, args.prompt_len + 1))
                         ).astype(np.int32) for _ in range(args.batch)]


def run_static(args, spec, params, device) -> Dict[str, Any]:
    """Static batched generation: ``--batch`` prompts of ``--prompt-len``
    tokens, ``--steps`` decode steps."""
    from repro_torch.serve.engine import ServeConfig, generate
    prompts = np.stack(_prompts(args, spec, args.prompt_len))
    cfg = ServeConfig(max_seq=args.prompt_len + args.steps + 1,
                      temperature=args.temperature,
                      weight_precision=args.precision,
                      attention_impl="naive")
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    batch = {"tokens": torch.as_tensor(prompts, dtype=torch.int64,
                                       device=device)}
    t0 = time.perf_counter()
    out = generate(params, spec, batch, args.steps, cfg, generator=gen)
    tokens = out["tokens"].cpu().numpy()        # waits for the device
    dt = time.perf_counter() - t0
    print(f"[serve] static engine on {device} ({args.precision} weights): "
          f"generated {args.batch}x{args.steps} tokens in {dt:.2f}s "
          f"({args.batch * args.steps / dt:.1f} tok/s)")
    print(tokens[:, :16])
    return {"prompts": prompts, "tokens": tokens, "seconds": dt,
            "tokens_per_s": args.batch * args.steps / dt}


def run_paged(args, spec, params, device) -> Dict[str, Any]:
    """Continuous batching end-to-end: submit ``--batch`` requests, drain
    the scheduler, report stats."""
    from repro_torch.serve.backend import SingleDeviceBackend
    from repro_torch.serve.scheduler import (ContinuousBatchingEngine,
                                             Request, SchedulerConfig)
    lo = args.min_prompt_len or max(4, args.prompt_len // 2)
    reqs = [Request(i, p, args.steps)
            for i, p in enumerate(_prompts(args, spec, lo))]
    cfg = SchedulerConfig(
        max_slots=min(8, args.batch), page_size=16,
        max_seq=args.prompt_len + args.steps + 16,
        kv_budget_bytes=64e6, cache_dtype=args.cache_dtype,
        spec_k=args.spec_k, prefill_chunk_tokens=args.prefill_chunk)
    backend = SingleDeviceBackend(params, spec, cfg, device=device)
    eng = ContinuousBatchingEngine(params, spec, cfg, backend=backend)
    t0 = time.perf_counter()
    done = eng.run(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    tok = sum(len(c.tokens) for c in done)
    usable = eng.layout.num_pages - 1
    occ = eng.stats["occupancy_sum"] / max(1, eng.stats["iterations"])
    print(f"[serve] paged engine on {device} ({args.precision} weights, "
          f"{args.cache_dtype} pages, spec_k={cfg.spec_k}): {len(done)} "
          f"requests, {tok} tokens in {dt:.2f}s ({tok / dt:.1f} tok/s)")
    print(f"[serve] pool: {eng.layout.num_pages} pages x "
          f"{eng.layout.page_size} tok, mean occupancy {occ:.2f}, "
          f"preemptions {int(eng.stats['preemptions'])}, "
          f"prefix hits {int(eng.stats['prefix_hit_tokens'])} tok "
          f"({usable} usable pages), {backend.decode_steps} decode steps")
    if cfg.prefill_chunk_tokens:
        print(f"[serve] chunked prefill: {cfg.prefill_chunk_tokens}-token "
              f"budget, {int(eng.stats['prefill_chunks'])} partial chunks")
    st = eng.stats
    if eng.ring:
        print(f"[serve] sliding window {eng.window}: ring tables "
              f"{eng.layout.slots_pages(cfg.max_seq)} pages/slot, "
              f"{int(st['ring_recycled_pages'])} pages recycled in place, "
              f"{int(st['ring_shared_released'])} shared entries released")
    if cfg.spec_k > 1:
        acc = st["spec_accepted"] / max(1, st["spec_drafted"])
        print(f"[serve] spec decode: {int(st['spec_steps'])} windows, "
              f"{int(st['spec_accepted'])}/{int(st['spec_drafted'])} drafts "
              f"accepted ({acc:.2f}), "
              f"{st['decode_tokens'] / max(1, st['iterations']):.2f} "
              "tokens/iteration")
    print(np.stack([c.tokens[:8] for c in done[:4]]))
    return {"engine": eng, "completions": done, "seconds": dt, "tokens": tok,
            "tokens_per_s": tok / dt, "decode_steps": backend.decode_steps,
            "spec_steps": int(st["spec_steps"]),
            "spec_drafted": int(st["spec_drafted"]),
            "spec_accepted": int(st["spec_accepted"])}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = build_parser()
    args = ap.parse_args(argv)
    msg = _refuse(args)
    if msg:
        ap.error(msg)
    device = resolve_device(args.device)
    spec = ARCHS[args.arch]
    if args.local:
        spec = spec.scaled_down(layers=args.layers, width=args.width,
                                vocab=args.vocab)
    if args.sliding_window:
        spec = spec.with_(sliding_window=args.sliding_window)
    params = lm.init(args.seed, spec, device=device)
    if args.precision in ("int8", "int4"):
        params = quantize_params(params, args.precision)
        print(f"[serve] weights quantized to {args.precision}")
    if args.engine == "paged":
        return run_paged(args, spec, params, device)
    return run_static(args, spec, params, device)


if __name__ == "__main__":
    main()
