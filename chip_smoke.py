#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device: the card, ``nvidia-smi`` name and power limit, torch/CUDA
   versions, and the build of the CUDA kernels from ``csrc/``;
2. kernels: each kernel against its plain PyTorch version on the card at
   full-width TinyLlama-1.1B shapes (paged attention: fp32/int8/int4
   pools x full/window/ring, B=8, H=32, KV=4, D=64, page 16, ragged
   lengths with a 0; dequantizing matmul: int8/int4 at M in {1, 8, 128}
   over the model's matmul shapes), timed with CUDA events;
3. decode parity: one full-width ``decode_step_paged`` from one paged
   cache state through the kernels and through the plain versions;
4. serve: ``repro_torch.launch.serve`` paged engine on full-width
   TinyLlama, 8 requests of 32-128 prompt tokens and 32 new tokens, with
   launch counters read around the run;
5. a ``{"kernels": [...]}`` line, the card's line, and the last line
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX.  Kernel timings are device time from CUDA
events, the mean of 20 launches, each on a cold L2 (a 128 MB buffer is
rewritten before every launch), enqueued in chunks of 5 while the card
sleeps so no host time enters them; bounds use the H100 SXM data-sheet rates,
3.35 TB/s and 67 TFLOP/s in fp32.
"""
from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
ARCH = "tinyllama-1.1b"
# max |kernel - plain| / max(1, max |plain|); both compute in f32 but sum
# in another order (online softmax over pages vs one softmax; sequential
# fma over K splits vs cuBLAS), which moves results by a few f32 ulps of
# the output's scale.
ATTN_TOL = 1e-5
QMM_TOL = 1e-5
# full-width decode logits: 22 layers of the above, plus the new token's
# K/V row quantized from slightly different floats, which can move one
# int8/int4 code by one step
DECODE_TOL = {"int8": 1e-3, "int4": 2e-3}


def fail(msg: str) -> None:
    print(f"[smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

class Timer:
    """Mean device ms of ``fn`` over launches on a cold L2.

    The card sleeps while the host enqueues a chunk of timed launches, so
    the events bracket device work only: without that, a launch whose
    host side (Python, argument checks) outlasts the L2 flush before it
    would count the host's time as the device's.  Chunks stay small so
    the launch queue never fills (a full queue blocks the host until the
    card drains it, and the host would always outrun the sleep)."""

    def __init__(self, torch, iters: int = 20, chunk: int = 5,
                 warmup: int = 3):
        self.torch, self.iters, self.chunk, self.warmup = (
            torch, iters, chunk, warmup)
        self.flush = torch.empty(32 * 2 ** 20, dtype=torch.float32,
                                 device="cuda")
        self.sleep_cycles = 50_000_000

    def _chunk(self, fn):
        torch = self.torch
        t0 = time.perf_counter()
        g0 = torch.cuda.Event(enable_timing=True)
        g1 = torch.cuda.Event(enable_timing=True)
        g0.record()
        torch.cuda._sleep(self.sleep_cycles)
        g1.record()
        pairs = []
        for _ in range(self.chunk):
            self.flush.fill_(1.0)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if host_ms >= 0.8 * g0.elapsed_time(g1):
            return None                # the host outran the sleep
        return sum(s.elapsed_time(e) for s, e in pairs)

    def __call__(self, fn) -> float:
        for _ in range(self.warmup):
            fn()
        self.torch.cuda.synchronize()
        total = 0.0
        for _ in range(self.iters // self.chunk):
            for _attempt in range(4):
                ms = self._chunk(fn)
                if ms is not None:
                    total += ms
                    break
                self.sleep_cycles *= 2
            else:
                fail("timer: the host could not enqueue a chunk of launches "
                     "within the card's sleep")
        return total / (self.iters // self.chunk * self.chunk)


# ---------------------------------------------------------------------------
# phase 1: device and build
# ---------------------------------------------------------------------------

def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    log(f"device: {name}, count {torch.cuda.device_count()}")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    except Exception as exc:  # noqa: BLE001 - reported and fatal
        fail(f"nvidia-smi: {exc}")
    print(f"[smoke] nvidia-smi: {smi}", flush=True)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    try:
        _build.build()
    except Exception as exc:  # noqa: BLE001 - reported and fatal
        fail(f"kernel build: {exc}")
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"({', '.join(_build.SOURCES)})")
    for src, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {src}: {line.strip()}")
    return name, smi


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

B, H, KV, D, PAGE = 8, 32, 4, 64, 16
N_ENTRIES = 11                 # pages per slot at max_seq 176 (serve phase)
LENGTHS = [0, 1, 33, 64, 97, 128, 150, 176]
WINDOW = 48


def _pool(torch, gen, quant: str, P: int):
    dev = "cuda"
    if quant == "none":
        k = torch.randn((P, PAGE, KV, D), generator=gen, device=dev)
        v = torch.randn((P, PAGE, KV, D), generator=gen, device=dev)
        return k, v, None, None
    tok = PAGE if quant == "int8" else PAGE // 2
    lo, hi = (-127, 128) if quant == "int8" else (-128, 128)
    k = torch.randint(lo, hi, (P, tok, KV, D), generator=gen, device=dev,
                      dtype=torch.int32).to(torch.int8)
    v = torch.randint(lo, hi, (P, tok, KV, D), generator=gen, device=dev,
                      dtype=torch.int32).to(torch.int8)
    ks = torch.rand((P, KV, PAGE), generator=gen, device=dev) * 0.02 + 0.005
    vs = torch.rand((P, KV, PAGE), generator=gen, device=dev) * 0.02 + 0.005
    return k, v, ks, vs


def _visited_pages(length: int, n_entries: int, window: int, ring: bool):
    """Pages holding a key the mask accepts (what the kernel reads)."""
    if length <= 0:
        return 0
    last = (length - 1) // PAGE
    lo_tok = max(length - window, 0) if window else 0
    if ring:
        n = 0
        for j in range(n_entries):
            ap = last - ((last - j) % n_entries)
            if ap >= 0 and ap * PAGE <= length - 1 and ap * PAGE + PAGE - 1 >= lo_tok:
                n += 1
        return n
    return min(last, n_entries - 1) + 1 - lo_tok // PAGE


def attn_bound(quant, lengths, n_entries, window, ring):
    vb = {"none": 4.0, "int8": 1.0, "int4": 0.5}[quant]
    pages = sum(_visited_pages(l, n_entries, window, ring) for l in lengths)
    per_page = PAGE * KV * D * vb * 2 + (PAGE * KV * 4 * 2 if quant != "none" else 0)
    keys = sum(min(l, window) if window else l for l in lengths)
    nbytes = pages * per_page + 2 * B * H * D * 4 + B * (n_entries + 1) * 4
    flops = 4.0 * H * D * keys
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def phase_kernels_attention(torch, timer, ops, F):
    gen = torch.Generator(device="cuda").manual_seed(1)
    results = {}
    for quant in ("none", "int8", "int4"):
        for mode in ("full", "window", "ring"):
            ring = mode == "ring"
            window = WINDOW if mode != "full" else 0
            n_entries = (-(-WINDOW // PAGE) + 1) if ring else N_ENTRIES
            P = 1 + B * n_entries
            kp, vp, ks, vs = _pool(torch, gen, quant, P)
            perm = torch.randperm(P - 1, generator=gen, device="cuda") + 1
            bt = perm[:B * n_entries].reshape(B, n_entries).to(torch.int32).contiguous()
            lengths = torch.tensor(LENGTHS, dtype=torch.int32, device="cuda")
            q = torch.randn((B, H, D), generator=gen, device="cuda")
            args = (q, kp, vp, bt, lengths)
            kw = dict(window=window, ring=ring, k_scale=ks, v_scale=vs)
            try:
                out = ops.paged_attention(*args, **kw)
                torch.cuda.synchronize()
            except Exception as exc:  # noqa: BLE001 - reported and fatal
                fail(f"paged_attention kernel [{quant},{mode}]: {exc}")
            ref = ops.paged_attention(*args, impl="plain", **kw)
            err = (out - ref).abs().max().item()
            scale = max(1.0, ref.abs().max().item())
            if not math.isfinite(err) or err / scale > ATTN_TOL:
                fail(f"paged_attention [{quant},{mode}] max abs err {err:.3e} "
                     f"> {ATTN_TOL} x {scale:.2f}")
            if not torch.all(out[0] == 0):
                fail(f"paged_attention [{quant},{mode}]: length-0 slot not zero")
            ms = timer(lambda: ops.paged_attention(*args, **kw))
            plain_ms = timer(lambda: ops.paged_attention(*args, impl="plain", **kw))
            # library yardstick: SDPA on K/V already gathered and dequantized
            kfull, vfull, mask = _gathered(torch, ops, args, kw, n_entries)
            qs = q[:, :, None, :]
            lib_ms = timer(lambda: F.scaled_dot_product_attention(
                qs, kfull, vfull, attn_mask=mask))
            bound_ms, bound_by = attn_bound(quant, LENGTHS, n_entries, window, ring)
            qn = {"none": "fp32"}.get(quant, quant)
            log(f"paged_attention [{qn:4s} {mode:6s}] err {err:.2e}  kernel "
                f"{ms:.4f} ms  plain {plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms  "
                f"bound {bound_ms:.5f} ms ({bound_by})")
            results[(qn, mode)] = dict(err=err, ms=ms, plain_ms=plain_ms,
                                       library_ms=lib_ms, bound_ms=bound_ms,
                                       bound_by=bound_by)
    return results


def _gathered(torch, ops, args, kw, n_entries):
    """(B, H, S, D) K/V and the (B, 1, 1, S) mask the plain version builds,
    for timing SDPA alone."""
    from repro_torch.kernels import paged_attention as pa
    q, kp, vp, bt, lengths = args
    quant, page = pa._pool_quant(kp, kw["k_scale"])
    if quant == "int4":
        kp = pa.unpack_int4(kp, axis=1)
        vp = pa.unpack_int4(vp, axis=1)
    k = kp[bt.long()].float()
    v = vp[bt.long()].float()
    if kw["k_scale"] is not None:
        k = k * torch.movedim(kw["k_scale"][bt.long()], -1, -2)[..., None]
        v = v * torch.movedim(kw["v_scale"][bt.long()], -1, -2)[..., None]
    S = n_entries * page
    k = k.reshape(B, S, KV, D).repeat_interleave(H // KV, dim=2).transpose(1, 2)
    v = v.reshape(B, S, KV, D).repeat_interleave(H // KV, dim=2).transpose(1, 2)
    L = lengths.long()
    if kw["ring"]:
        idx = pa._ring_positions(L, n_entries, page)
        valid = (idx >= 0) & (idx < L[:, None])
    else:
        idx = torch.arange(S, device="cuda")[None].expand(B, S)
        valid = idx < L[:, None]
    if kw["window"]:
        valid = valid & (idx > L[:, None] - 1 - kw["window"])
    return k.contiguous(), v.contiguous(), valid[:, None, None, :]


QMM_SHAPES = [(2048, 2048), (2048, 256), (2048, 11264), (5632, 2048),
              (2048, 32000)]
QMM_M = (1, 8, 128)


def qmm_bound(M, K, N, bits):
    wbytes = K * N * (1 if bits == 8 else 0.5)
    sbytes = (N if bits == 8 else (K // 32) * N) * 4
    nbytes = wbytes + sbytes + M * K * 4 + M * N * 4
    flops = 2.0 * M * K * N
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def phase_kernels_matmul(torch, timer, ops):
    from repro_torch.quant.qtypes import W4_SYM_GROUP, W8_SYM_CHANNEL
    from repro_torch.quant.quantize import dequantize, quantize
    gen = torch.Generator(device="cuda").manual_seed(2)
    results = {}
    for bits, cfg in ((8, W8_SYM_CHANNEL), (4, W4_SYM_GROUP)):
        for K, N in QMM_SHAPES:
            w = quantize(torch.randn((K, N), generator=gen, device="cuda") * 0.02, cfg)
            wf = dequantize(w)
            for M in QMM_M:
                x = torch.randn((M, K), generator=gen, device="cuda")
                try:
                    out = ops.quant_matmul(x, w)
                    torch.cuda.synchronize()
                except Exception as exc:  # noqa: BLE001 - reported and fatal
                    fail(f"quant_matmul kernel [w{bits} M={M} {K}x{N}]: {exc}")
                ref = ops.quant_matmul(x, w, impl="plain")
                err = (out - ref).abs().max().item()
                scale = max(1.0, ref.abs().max().item())
                if not math.isfinite(err) or err / scale > QMM_TOL:
                    fail(f"quant_matmul [w{bits} M={M} {K}x{N}] max abs err "
                         f"{err:.3e} > {QMM_TOL} x {scale:.2f}")
                ms = timer(lambda: ops.quant_matmul(x, w))
                plain_ms = timer(lambda: ops.quant_matmul(x, w, impl="plain"))
                lib_ms = timer(lambda: torch.matmul(x, wf))
                bound_ms, bound_by = qmm_bound(M, K, N, bits)
                log(f"quant_matmul [w{bits} M={M:3d} {K:5d}x{N:5d}] err {err:.2e}  "
                    f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  matmul "
                    f"{lib_ms:.4f} ms  bound {bound_ms:.5f} ms ({bound_by})")
                results[(bits, M, K, N)] = dict(err=err, ms=ms, plain_ms=plain_ms,
                                                library_ms=lib_ms, bound_ms=bound_ms,
                                                bound_by=bound_by)
    # one decode step's matmuls at M=8: six per layer plus the head
    per_layer = [(2048, 2048), (2048, 256), (2048, 256), (2048, 2048),
                 (2048, 11264), (5632, 2048)]
    for bits in (8, 4):
        step = {k: 22 * sum(results[(bits, 8, a, b)][k] for a, b in per_layer)
                + results[(bits, 8, 2048, 32000)][k]
                for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        log(f"quant_matmul [w{bits} M=8] one decode step (133 launches, summed "
            f"from the cases above): kernel {step['ms']:.3f} ms  plain "
            f"{step['plain_ms']:.3f} ms  matmul {step['library_ms']:.3f} ms  "
            f"bound {step['bound_ms']:.3f} ms")
    return results


# ---------------------------------------------------------------------------
# phase 3: full-width decode step, kernels vs plain
# ---------------------------------------------------------------------------

def phase_decode_parity(torch, precision: str, cache_dtype: str):
    import numpy as np
    from repro_torch.configs import ARCHS
    from repro_torch.models import lm
    from repro_torch.quant.qlinear import quantize_params
    from repro_torch.serve.backend import SingleDeviceBackend
    from repro_torch.serve.scheduler import SchedulerConfig
    spec = ARCHS[ARCH]
    params = lm.init(0, spec, device="cuda")
    if precision != "fp32":
        params = quantize_params(params, precision)
    cfg = SchedulerConfig(max_slots=8, page_size=16, max_seq=176,
                          num_pages=1 + 8 * 11, cache_dtype=cache_dtype)
    be = SingleDeviceBackend(params, spec, cfg, device="cuda")
    rng = np.random.default_rng(3)
    first = []
    for slot in range(8):
        plen = int(rng.integers(32, 129))
        n_pages = -(-plen // 16)
        bucket = 16
        while bucket < plen:
            bucket *= 2
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :plen] = rng.integers(0, spec.vocab_size, size=plen)
        row = np.zeros((11,), np.int32)
        row[:n_pages + 1] = 1 + slot * 11 + np.arange(n_pages + 1)
        first.append(be.admit_full(padded, slot, plen, row))
    tokens = torch.tensor(first, dtype=torch.int64, device="cuda")[:, None]
    cache_k = copy.deepcopy(be.cache)
    cache_p = copy.deepcopy(be.cache)
    with torch.no_grad():
        lk, _ = lm.decode_step_paged(be.params, spec, cache_k, tokens)
        lp, _ = lm.decode_step_paged(be.params, spec, cache_p, tokens,
                                     impl="plain")
    torch.cuda.synchronize()
    if tuple(lk.shape) != (8, 1, spec.padded_vocab) or not torch.all(torch.isfinite(lk)):
        fail(f"decode logits [{precision}/{cache_dtype}]: shape {tuple(lk.shape)} "
             "or non-finite values")
    err = (lk - lp).abs().max().item()
    scale = max(1.0, lp.abs().max().item())
    tol = DECODE_TOL[cache_dtype if cache_dtype != "fp32" else "int8"]
    match = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
    log(f"decode parity [{precision} weights, {cache_dtype} pages]: max abs err "
        f"{err:.3e} (logit scale {scale:.3f}, tol {tol} x scale), argmax match "
        f"{match:.3f} (information only)")
    if not math.isfinite(err) or err / scale > tol:
        fail(f"decode parity [{precision}/{cache_dtype}] {err:.3e} > {tol} x {scale:.3f}")
    # host wall time of a full-width decode step (8 slots) through the
    # kernels, after the step above warmed everything up
    n = 5
    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(n):
            lm.decode_step_paged(be.params, spec, cache_k, tokens)
    torch.cuda.synchronize()
    log(f"decode step wall [{precision} weights, {cache_dtype} pages]: "
        f"{(time.perf_counter() - t0) * 1e3 / n:.2f} ms per step (host clock, "
        f"mean of {n}, 8 slots)")
    del be, params, cache_k, cache_p
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4: serve through the launcher
# ---------------------------------------------------------------------------

def phase_serve(torch, ops, precision: str, cache_dtype: str):
    from repro_torch.launch import serve
    argv = ["--engine", "paged", "--arch", ARCH, "--precision", precision,
            "--cache-dtype", cache_dtype, "--batch", "8", "--prompt-len", "128",
            "--min-prompt-len", "32", "--steps", "32", "--device", "cuda"]
    ops.reset_launch_counts()
    try:
        res = serve.main(argv)
    except Exception as exc:  # noqa: BLE001 - reported and fatal
        fail(f"serve [{precision}/{cache_dtype}]: {exc!r}")
    counts = ops.launch_counts()
    eng, done = res["engine"], res["completions"]
    eng.alloc.check()
    bad = [c.uid for c in done if c.status != "ok" or len(c.tokens) != 32]
    if len(done) != 8 or bad:
        fail(f"serve [{precision}/{cache_dtype}]: {len(done)} completions, bad {bad}")
    vocab = eng.spec.vocab_size
    if any(int(t) < 0 or int(t) >= eng.spec.padded_vocab for c in done for t in c.tokens):
        fail("serve: token id out of range")
    steps = res["decode_steps"]
    n_layers = eng.spec.num_layers
    if counts["paged_attention"] != n_layers * steps:
        fail(f"serve [{precision}/{cache_dtype}]: paged attention launches "
             f"{counts['paged_attention']} != {n_layers} x {steps} decode steps")
    if precision != "fp32" and counts["quant_matmul"] == 0:
        fail(f"serve [{precision}]: the dequantizing matmul never launched")
    log(f"serve [{precision} weights, {cache_dtype} pages]: {res['tokens']} tokens "
        f"in {res['seconds']:.3f} s = {res['tokens_per_s']:.1f} tok/s; "
        f"{steps} decode steps; launches {counts} (vocab {vocab})")
    del res, eng, done
    torch.cuda.empty_cache()
    return counts, steps


# ---------------------------------------------------------------------------

def main(argv):
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a CUDA card")
    phases = set(argv[0].split(",")) if argv else {
        "kernels", "decode", "serve"}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import ops
    name, smi = phase_device(torch)
    timer = Timer(torch)
    attn = qmm = None
    if "kernels" in phases:
        attn = phase_kernels_attention(torch, timer, ops, F)
        qmm = phase_kernels_matmul(torch, timer, ops)
    if "decode" in phases:
        phase_decode_parity(torch, "int4", "int8")
        phase_decode_parity(torch, "fp32", "int4")
    launches = {"paged_attention": 0, "quant_matmul": 0}
    if "serve" in phases:
        for precision, cache_dtype in (("int4", "int8"), ("fp32", "int4")):
            counts, _ = phase_serve(torch, ops, precision, cache_dtype)
            for k in launches:
                launches[k] += counts[k]
    kernels = []
    if attn is not None:
        a = attn[("int8", "full")]
        m = qmm[(4, 8, 2048, 11264)]
        kernels = [
            {"name": "paged_attention", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
             "replaces": "src/repro/kernels/paged_attention.py:122",
             "launches": launches["paged_attention"], "max_abs_err": a["err"],
             "ms": a["ms"], "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
             "bound_by": a["bound_by"], "library_ms": a["library_ms"]},
            {"name": "quant_matmul", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/quant_matmul.cu",
             "replaces": "src/repro/kernels/quant_matmul.py:45",
             "launches": launches["quant_matmul"], "max_abs_err": m["err"],
             "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
             "bound_by": m["bound_by"], "library_ms": m["library_ms"]},
        ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"[smoke] card: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
