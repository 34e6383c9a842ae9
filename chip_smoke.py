#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device: the card, ``nvidia-smi`` name and power limit, torch/CUDA
   versions, and the build of the CUDA kernels from ``csrc/``;
2. kernels: each kernel against its plain PyTorch version on the card at
   full-width TinyLlama-1.1B shapes (paged attention: fp32/int8/int4
   pools x full/window/ring, B=8, H=32, KV=4, D=64, page 16, ragged
   lengths with a 0, for one query and for a K=4 verify window;
   dequantizing matmul: int8/int4 at M in {1, 8, 128} over the model's
   matmul shapes; flash attention: B=1, H=32, KV=4, D=64, causal, Sq=Sk
   in {128, 256, 512}, Sq=128 against Sk=256, and a 128-token window),
   timed with CUDA events beside the bound and one library call;
3. decode parity: one full-width ``decode_step_paged`` and one K=4
   ``decode_window_paged`` from one paged cache state through the
   kernels and through the plain versions, each window position against
   the sequential decode steps it stands for, and the backend's verify
   step accepting greedy drafts; then the host wall time and the device
   busy time (``torch.profiler``) of a K=1 step and a verify step;
4. serve: ``repro_torch.launch.serve`` paged engine on full-width
   TinyLlama, 8 requests of 32-128 prompt tokens and 32 new tokens, with
   launch counters read around each run: K=1 decode for two precisions,
   then ``--spec-k 4`` (its streams held against the K=1 run's), then
   ``spec_k=4`` at the library boundary on prompts that repeat a segment
   (so that windows draft at full width), held against ``spec_k=1``;
   then cold admission through flash attention
   (``attention_impl="pallas"``) at the library boundary, prompts of
   65-256 tokens, held against the sdpa admission;
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
# full-width prompt logits, flash kernel against sdpa: 22 layers of f32
# attention summed in another order (online softmax over 32-key tiles),
# no quantized K/V in between
PREFILL_TOL = 1e-4


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


def _visited_pages(length: int, n_entries: int, window: int, ring: bool,
                   K: int = 1):
    """Pages holding a key the mask accepts for any of the K queries
    (what the kernel reads)."""
    if length <= 0:
        return 0
    last = (length - 1) // PAGE
    lo_tok = max(length - K - window + 1, 0) if window else 0
    if ring:
        n = 0
        for j in range(n_entries):
            ap = last - ((last - j) % n_entries)
            if ap >= 0 and ap * PAGE <= length - 1 and ap * PAGE + PAGE - 1 >= lo_tok:
                n += 1
        return n
    return min(last, n_entries - 1) + 1 - lo_tok // PAGE


def attn_bound(quant, lengths, n_entries, window, ring, K=1):
    """Least time for the paged attention of ``lengths`` (K queries per
    slot, query j at length - K + j): the live pages, q and the output
    once, against 4*D flops per (query head, valid key)."""
    vb = {"none": 4.0, "int8": 1.0, "int4": 0.5}[quant]
    pages = sum(_visited_pages(l, n_entries, window, ring, K) for l in lengths)
    per_page = PAGE * KV * D * vb * 2 + (PAGE * KV * 4 * 2 if quant != "none" else 0)
    keys = sum(min(p + 1, window) if window else p + 1
               for l in lengths for p in range(l - K, l) if p >= 0)
    nbytes = pages * per_page + 2 * B * K * H * D * 4 + B * (n_entries + 1) * 4
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
    """(B, H, S, D) K/V and the (B, 1, K, S) mask the plain version builds
    (K = 1 for a 3-D q), for timing SDPA alone."""
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
    K = q.shape[1] if q.ndim == 4 else 1
    q_abs = (L[:, None] - K + torch.arange(K, device="cuda")[None])[..., None]
    if kw["ring"]:
        idx = pa._ring_positions(L, n_entries, page)[:, None]
        valid = (idx >= 0) & (idx <= q_abs)
    else:
        idx = torch.arange(S, device="cuda")[None, None]
        valid = idx <= q_abs
    if kw["window"]:
        valid = valid & (q_abs - idx < kw["window"])
    return k.contiguous(), v.contiguous(), valid[:, None]


WQ = 4                                          # verify window (--spec-k 4)
W_LENGTHS = [0, 4, 37, 68, 101, 132, 154, 176]  # contexts incl. the window


def phase_kernels_window(torch, timer, ops, F):
    """The K-token verify window kernel against its plain version."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    results = {}
    for quant in ("none", "int8", "int4"):
        for mode in ("full", "window", "ring"):
            ring = mode == "ring"
            window = WINDOW if mode != "full" else 0
            # a ring holds the window plus the K-1 newer tokens
            n_entries = (-(-(WINDOW + WQ - 1) // PAGE) + 1) if ring else N_ENTRIES
            P = 1 + B * n_entries
            kp, vp, ks, vs = _pool(torch, gen, quant, P)
            perm = torch.randperm(P - 1, generator=gen, device="cuda") + 1
            bt = perm[:B * n_entries].reshape(B, n_entries).to(torch.int32).contiguous()
            lengths = torch.tensor(W_LENGTHS, dtype=torch.int32, device="cuda")
            q = torch.randn((B, WQ, H, D), generator=gen, device="cuda")
            args = (q, kp, vp, bt, lengths)
            kw = dict(window=window, ring=ring, k_scale=ks, v_scale=vs)
            try:
                out = ops.paged_attention(*args, **kw)
                torch.cuda.synchronize()
            except Exception as exc:  # noqa: BLE001 - reported and fatal
                fail(f"paged_window kernel [{quant},{mode}]: {exc}")
            ref = ops.paged_attention(*args, impl="plain", **kw)
            err = (out - ref).abs().max().item()
            scale = max(1.0, ref.abs().max().item())
            if not math.isfinite(err) or err / scale > ATTN_TOL:
                fail(f"paged_window [{quant},{mode}] max abs err {err:.3e} "
                     f"> {ATTN_TOL} x {scale:.2f}")
            if not torch.all(out[0] == 0):
                fail(f"paged_window [{quant},{mode}]: length-0 slot not zero")
            ms = timer(lambda: ops.paged_attention(*args, **kw))
            plain_ms = timer(lambda: ops.paged_attention(*args, impl="plain", **kw))
            kfull, vfull, mask = _gathered(torch, ops, args, kw, n_entries)
            qs = q.transpose(1, 2).contiguous()                # (B, H, K, D)
            lib_ms = timer(lambda: F.scaled_dot_product_attention(
                qs, kfull, vfull, attn_mask=mask))
            bound_ms, bound_by = attn_bound(quant, W_LENGTHS, n_entries,
                                            window, ring, K=WQ)
            qn = {"none": "fp32"}.get(quant, quant)
            log(f"paged_window K={WQ} [{qn:4s} {mode:6s}] err {err:.2e}  kernel "
                f"{ms:.4f} ms  plain {plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms  "
                f"bound {bound_ms:.5f} ms ({bound_by})")
            results[(qn, mode)] = dict(err=err, ms=ms, plain_ms=plain_ms,
                                       library_ms=lib_ms, bound_ms=bound_ms,
                                       bound_by=bound_by)
    return results


FLASH_CASES = [  # (Sq, Sk, window), causal, B=1
    (128, 128, 0), (256, 256, 0), (512, 512, 0), (128, 256, 0),
    (512, 512, 128)]


def flash_bound(torch, mask, Sq, Sk):
    """q, k, v and the output once; 4*D flops per (query head, key) pair
    the mask keeps (the causal half, the window band)."""
    pairs = int(mask.sum().item())
    nbytes = 4 * (2 * Sq * H * D + 2 * Sk * KV * D)
    flops = 4.0 * D * H * pairs
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def phase_kernels_flash(torch, timer, ops, F):
    """The flash-attention kernel against its plain version."""
    from repro_torch.kernels.flash_attention import attention_mask
    gen = torch.Generator(device="cuda").manual_seed(5)
    results = {}
    for Sq, Sk, window in FLASH_CASES:
        q = torch.randn((1, Sq, H, D), generator=gen, device="cuda")
        k = torch.randn((1, Sk, KV, D), generator=gen, device="cuda")
        v = torch.randn((1, Sk, KV, D), generator=gen, device="cuda")
        kw = dict(causal=True, window=window)
        try:
            out = ops.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
        except Exception as exc:  # noqa: BLE001 - reported and fatal
            fail(f"flash_attention kernel [{Sq}x{Sk} w{window}]: {exc}")
        ref = ops.flash_attention(q, k, v, impl="plain", **kw)
        err = (out - ref).abs().max().item()
        scale = max(1.0, ref.abs().max().item())
        if not math.isfinite(err) or err / scale > ATTN_TOL:
            fail(f"flash_attention [{Sq}x{Sk} w{window}] max abs err {err:.3e} "
                 f"> {ATTN_TOL} x {scale:.2f}")
        ms = timer(lambda: ops.flash_attention(q, k, v, **kw))
        plain_ms = timer(lambda: ops.flash_attention(q, k, v, impl="plain", **kw))
        mask = attention_mask(Sq, Sk, causal=True, window=window, device="cuda")
        qt = q.transpose(1, 2).contiguous()
        kt = k.transpose(1, 2).contiguous()
        vt = v.transpose(1, 2).contiguous()
        try:
            F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                           enable_gqa=True)
            gqa = {"enable_gqa": True}
        except TypeError:          # a torch without enable_gqa: repeat K/V
            kt = kt.repeat_interleave(H // KV, dim=1)
            vt = vt.repeat_interleave(H // KV, dim=1)
            gqa = {}
        lib_ms = timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, **gqa))
        bound_ms, bound_by = flash_bound(torch, mask, Sq, Sk)
        log(f"flash_attention [Sq {Sq:3d} Sk {Sk:3d} window {window:3d}] err "
            f"{err:.2e}  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  sdpa "
            f"{lib_ms:.4f} ms  bound {bound_ms:.5f} ms ({bound_by})")
        results[(Sq, Sk, window)] = dict(err=err, ms=ms, plain_ms=plain_ms,
                                         library_ms=lib_ms, bound_ms=bound_ms,
                                         bound_by=bound_by)
    return results


QMM_SHAPES = [(2048, 2048), (2048, 256), (2048, 11264), (5632, 2048),
              (2048, 32000)]
QMM_M = (1, 8, 32, 128)          # 32 = B*K rows of a K=4 verify step


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
        for M, what in ((8, "decode step"), (32, f"K={WQ} verify step")):
            step = {k: 22 * sum(results[(bits, M, a, b)][k] for a, b in per_layer)
                    + results[(bits, M, 2048, 32000)][k]
                    for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
            log(f"quant_matmul [w{bits} M={M}] one {what} (133 launches, summed "
                f"from the cases above): kernel {step['ms']:.3f} ms  plain "
                f"{step['plain_ms']:.3f} ms  matmul {step['library_ms']:.3f} ms  "
                f"bound {step['bound_ms']:.3f} ms")
    return results


# ---------------------------------------------------------------------------
# phase 3: full-width decode step, kernels vs plain
# ---------------------------------------------------------------------------

def _model(precision: str):
    from repro_torch.configs import ARCHS
    from repro_torch.models import lm
    from repro_torch.quant.qlinear import quantize_params
    spec = ARCHS[ARCH]
    params = lm.init(0, spec, device="cuda")
    if precision != "fp32":
        params = quantize_params(params, precision)
    return spec, params


def _admitted_backend(torch, precision: str, cache_dtype: str):
    """A full-width backend with 8 slots cold-admitted (prompts of 32-128
    tokens, one spare page each) and their first tokens (8, 1)."""
    import numpy as np
    from repro_torch.serve.backend import SingleDeviceBackend
    from repro_torch.serve.scheduler import SchedulerConfig
    spec, params = _model(precision)
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
    return be, spec, tokens


def phase_decode_parity(torch, precision: str, cache_dtype: str):
    from repro_torch.models import lm
    be, spec, tokens = _admitted_backend(torch, precision, cache_dtype)
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
    del be, cache_k, cache_p
    torch.cuda.empty_cache()


def phase_window_parity(torch, precision: str, cache_dtype: str):
    """One K=4 verify window at full width from one cache state, through
    the kernels against the plain versions (ragged lens); then a window
    of greedy tokens against the K sequential decode steps it replaces,
    and the backend's fused verify step fed those greedy drafts, which
    must accept them on the device."""
    import numpy as np
    from repro_torch.models import lm
    be, spec, tokens = _admitted_backend(torch, precision, cache_dtype)
    cache0 = copy.deepcopy(be.cache)
    tol = DECODE_TOL[cache_dtype if cache_dtype != "fp32" else "int8"]
    tag = f"[{precision} weights, {cache_dtype} pages]"
    rng = np.random.default_rng(5)
    drafts = torch.tensor(rng.integers(0, spec.vocab_size, size=(8, WQ - 1)),
                          dtype=torch.int64, device="cuda")
    window = torch.cat([tokens, drafts], dim=1)
    lens = torch.tensor([4, 4, 3, 2, 1, 4, 4, 4], dtype=torch.int32, device="cuda")
    cache_k = copy.deepcopy(be.cache)
    cache_p = copy.deepcopy(be.cache)
    with torch.no_grad():
        lk, _ = lm.decode_window_paged(be.params, spec, cache_k, window, lens)
        lp, _ = lm.decode_window_paged(be.params, spec, cache_p, window, lens,
                                       impl="plain")
    torch.cuda.synchronize()
    if tuple(lk.shape) != (8, WQ, spec.padded_vocab) or not torch.all(torch.isfinite(lk)):
        fail(f"window logits {tag}: shape {tuple(lk.shape)} or non-finite values")
    err = (lk - lp).abs().max().item()
    scale = max(1.0, lp.abs().max().item())
    match = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
    log(f"window parity {tag}: kernels vs plain max abs err {err:.3e} (logit "
        f"scale {scale:.3f}, tol {tol} x scale), argmax match {match:.3f} "
        "(information only)")
    if not math.isfinite(err) or err / scale > tol:
        fail(f"window parity {tag} {err:.3e} > {tol} x {scale:.3f}")
    # greedy window vs sequential decode, both through the kernels
    seq = copy.deepcopy(be.cache)
    win = copy.deepcopy(be.cache)
    toks, seq_logits = [tokens], []
    with torch.no_grad():
        for _ in range(WQ):
            l, seq = lm.decode_step_paged(be.params, spec, seq, toks[-1])
            seq_logits.append(l[:, 0])
            toks.append(l[:, 0].argmax(-1)[:, None])
        full = torch.full((8,), WQ, dtype=torch.int32, device="cuda")
        wl, _ = lm.decode_window_paged(be.params, spec, win,
                                       torch.cat(toks[:WQ], dim=1), full)
    torch.cuda.synchronize()
    for j in range(WQ):
        e = (wl[:, j] - seq_logits[j]).abs().max().item()
        sc = max(1.0, seq_logits[j].abs().max().item())
        same = int((wl[:, j].argmax(-1) == seq_logits[j].argmax(-1)).sum())
        log(f"window position {j} vs {j + 1} sequential decode steps {tag}: max "
            f"abs err {e:.3e} (tol {tol} x {sc:.3f}), argmax equal on {same}/8 "
            "slots")
        if not math.isfinite(e) or e / sc > tol:
            fail(f"window position {j} {tag}: {e:.3e} > {tol} x {sc:.3f}")
    # the fused verify step with the greedy tokens as drafts: every slot's
    # window argmaxes equal the sequential ones, so it emits all K tokens,
    # and they are the sequential greedy stream
    agree = torch.stack([wl[:, j].argmax(-1) == seq_logits[j].argmax(-1)
                         for j in range(WQ)], dim=1).all(dim=1).cpu().numpy()
    greedy = torch.cat(toks[1:WQ + 1], dim=1).cpu().numpy()
    be.cache = cache0
    pos0 = be.cache["pos"].cpu().numpy().copy()
    out, n_emit, ok = be.decode(torch.cat(toks[:WQ], dim=1).cpu().numpy(),
                                np.ones(8, np.int32), np.full(8, WQ, np.int32))
    torch.cuda.synchronize()
    pos1 = be.cache["pos"].cpu().numpy()
    log(f"verify step with greedy drafts {tag}: emitted {n_emit.tolist()} "
        f"(all {WQ - 1} drafts accepted on {int((n_emit == WQ).sum())}/8 slots; "
        f"window argmaxes equal to sequential on {int(agree.sum())}/8)")
    bad = [b for b in range(8)
           if not agree[b] or n_emit[b] != WQ
           or not np.array_equal(out[b], greedy[b])]
    if bad or not np.all(ok == 1) or not np.array_equal(pos1, pos0 + n_emit):
        fail(f"verify step {tag}: slots {bad} flipped a window argmax or did "
             f"not accept all {WQ - 1} greedy drafts, or ok {ok.tolist()}, or "
             f"pos {pos0.tolist()} -> {pos1.tolist()}")
    del be, cache_k, cache_p, seq, win, cache0
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4: serve through the launcher
# ---------------------------------------------------------------------------

def device_busy_ms(torch, fn, n: int = 3):
    """Mean device busy time per call of ``fn`` (sum of the device time
    of every kernel and copy in a ``torch.profiler`` trace of ``n``
    calls), or None when the trace shows no device time.  Only the
    device rows count: an operator's row repeats the time of the kernels
    it launched, so the profiler's own table totals them alone too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False))
    return us / 1e3 / n if us > 0 else None


def phase_step_profile(torch, precision: str, cache_dtype: str):
    """Host wall time and device busy time of one backend decode call at
    full width, 8 slots: a K=1 step against a K=4 verify step (random
    drafts).  On a host shared with other work the host-side time can
    drift by 2x within one run, so the two are timed in turns (median
    of 6 each).  Information only."""
    import numpy as np
    be, spec, tokens = _admitted_backend(torch, precision, cache_dtype)
    cache0 = copy.deepcopy(be.cache)
    tag = f"[{precision} weights, {cache_dtype} pages]"
    tok1 = tokens.cpu().numpy().astype(np.int32)
    rng = np.random.default_rng(9)
    window = np.concatenate(
        [tok1, rng.integers(0, spec.vocab_size, size=(8, WQ - 1))], axis=1
    ).astype(np.int32)
    act = np.ones(8, np.int32)
    cases = {"K=1 decode step": (tok1, act),
             f"K={WQ} verify step": (window, act, np.full(8, WQ, np.int32))}
    walls = {name: [] for name in cases}
    for _ in range(7):                 # the first round warms up
        for name, args in cases.items():
            be.cache = copy.deepcopy(cache0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            be.decode(*args)           # ends in a device-to-host copy
            walls[name].append((time.perf_counter() - t0) * 1e3)
    for name, args in cases.items():
        wall = float(np.median(walls[name][1:]))
        be.cache = copy.deepcopy(cache0)
        try:
            busy = device_busy_ms(torch, lambda: be.decode(*args), 3)
        except Exception as exc:  # noqa: BLE001 - information only
            busy, why = None, repr(exc)
        else:
            why = "the trace shows no device time"
        dev = (f"device busy {busy:.2f} ms ({1 - busy / wall:.1%} of the median "
               "wall idle)" if busy is not None else f"device busy not measured ({why})")
        log(f"{name} {tag}: wall median {wall:.2f} ms of "
            f"{[round(w, 1) for w in walls[name][1:]]} (host clock, in turns), "
            f"{dev}")
    del be, cache0
    torch.cuda.empty_cache()


def phase_serve(torch, ops, precision: str, cache_dtype: str, spec_k: int = 1):
    """One launcher run; returns its launch counts, decode steps and
    completions.  With ``spec_k > 1`` every decode step is a verify
    window."""
    from repro_torch.launch import serve
    argv = ["--engine", "paged", "--arch", ARCH, "--precision", precision,
            "--cache-dtype", cache_dtype, "--batch", "8", "--prompt-len", "128",
            "--min-prompt-len", "32", "--steps", "32", "--device", "cuda",
            "--spec-k", str(spec_k)]
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
    attn, other = (("paged_window", "paged_attention") if spec_k > 1
                   else ("paged_attention", "paged_window"))
    if counts[attn] != n_layers * steps or counts[other]:
        fail(f"serve [{precision}/{cache_dtype} spec_k={spec_k}]: {attn} "
             f"launches {counts[attn]} != {n_layers} x {steps} decode steps, "
             f"or {other} launched {counts[other]} times")
    if precision != "fp32" and counts["quant_matmul"] == 0:
        fail(f"serve [{precision}]: the dequantizing matmul never launched")
    log(f"serve [{precision} weights, {cache_dtype} pages, spec_k={spec_k}]: "
        f"{res['tokens']} tokens in {res['seconds']:.3f} s = "
        f"{res['tokens_per_s']:.1f} tok/s; {steps} decode steps "
        f"({res['seconds'] * 1e3 / steps:.2f} ms per step, host clock, "
        f"admissions included); spec windows {res['spec_steps']}, drafts "
        f"accepted {res['spec_accepted']}/{res['spec_drafted']}; launches "
        f"{counts} (vocab {vocab})")
    streams = [c.tokens for c in done]
    del res, eng, done
    torch.cuda.empty_cache()
    return counts, steps, streams


def phase_serve_spec_repeating(torch, ops, precision: str, cache_dtype: str):
    """``spec_k=4`` at the library boundary on prompts that repeat a
    segment (seg + seg + seg[:3], seg of 16-32 tokens), so the n-gram
    tables draft from the prompt: full-width random weights do not loop
    within 32 greedy tokens, so the launcher's random prompts may never
    draft.  Requires drafted windows and one window launch per layer and
    step; streams held against spec_k=1 on the same prompts."""
    import numpy as np
    from repro_torch.serve.backend import SingleDeviceBackend
    from repro_torch.serve.scheduler import (ContinuousBatchingEngine,
                                             Request, SchedulerConfig)
    spec, params = _model(precision)
    tag = f"[{precision} weights, {cache_dtype} pages]"
    rng = np.random.default_rng(7)
    prompts = []
    for _ in range(8):
        seg = rng.integers(0, spec.vocab_size, size=int(rng.integers(16, 33)))
        prompts.append(np.concatenate([seg, seg, seg[:3]]).astype(np.int32))
    runs = {}
    for spec_k in (WQ, 1):
        cfg = SchedulerConfig(max_slots=8, page_size=16, max_seq=128,
                              kv_budget_bytes=64e6, cache_dtype=cache_dtype,
                              spec_k=spec_k)
        be = SingleDeviceBackend(params, spec, cfg, device="cuda")
        eng = ContinuousBatchingEngine(params, spec, cfg, backend=be)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            done = eng.run([Request(i, p.copy(), 32) for i, p in enumerate(prompts)])
            torch.cuda.synchronize()
        except Exception as exc:  # noqa: BLE001 - reported and fatal
            fail(f"serve spec {tag} spec_k={spec_k}: {exc!r}")
        dt = time.perf_counter() - t0
        counts = ops.launch_counts()
        eng.alloc.check()
        st = eng.stats
        if len(done) != 8 or any(c.status != "ok" or len(c.tokens) != 32 for c in done):
            fail(f"serve spec {tag} spec_k={spec_k}: bad completions")
        attn = "paged_window" if spec_k > 1 else "paged_attention"
        if counts[attn] != spec.num_layers * be.decode_steps:
            fail(f"serve spec {tag} spec_k={spec_k}: {attn} launches "
                 f"{counts[attn]} != {spec.num_layers} x {be.decode_steps} steps")
        if spec_k > 1 and st["spec_steps"] == 0:
            fail(f"serve spec {tag}: no window drafted")
        tok = sum(len(c.tokens) for c in done)
        log(f"serve spec {tag} library boundary, repeating prompts, spec_k="
            f"{spec_k}: {tok} tokens in {dt:.3f} s = {tok / dt:.1f} tok/s; "
            f"{be.decode_steps} decode steps, {int(st['iterations'])} iterations, "
            f"{st['decode_tokens'] / max(1, st['iterations']):.2f} tokens/iteration; "
            f"spec windows {int(st['spec_steps'])}, drafts accepted "
            f"{int(st['spec_accepted'])}/{int(st['spec_drafted'])}; launches {counts}")
        runs[spec_k] = ([c.tokens for c in done], counts)
        del eng, be, done
        torch.cuda.empty_cache()
    compare_streams(runs[WQ][0], runs[1][0],
                    f"serve spec {tag} repeating prompts: spec_k={WQ} vs spec_k=1")
    return runs[WQ][1]


def compare_streams(a, b, what: str) -> None:
    """Greedy streams of two runs: the exact-match fraction, and a fatal
    check against the ``assert_close_tokens`` band of tests/tolerance.py
    (matching prefix >= 0.9 of each stream)."""
    import numpy as np
    sys.path.insert(0, str(ROOT / "tests"))
    from tolerance import token_match_fraction
    fracs = [token_match_fraction(x, y) for x, y in zip(a, b)]
    exact = sum(bool(np.array_equal(x, y)) for x, y in zip(a, b)) / len(a)
    log(f"{what}: exact-match fraction {exact:.3f} of {len(a)} streams; "
        f"matching-prefix fractions {[round(f, 3) for f in fracs]}")
    if len(a) != len(b) or min(fracs) < 0.9:
        fail(f"{what}: streams diverge below the 0.9 matching-prefix band")


def phase_serve_flash(torch, ops, precision: str, cache_dtype: str):
    """Cold admission through the flash kernel at the library boundary:
    ``ContinuousBatchingEngine(params, spec, SchedulerConfig(...,
    attention_impl="pallas"))``, 6 prompts of 65-256 tokens (they bucket
    to 128 or 256 tokens), 16 new tokens each; streams held against the
    sdpa admission of the same requests.  First, one full-width prompt's
    logits through flash against sdpa."""
    import numpy as np
    from repro_torch.models import lm
    from repro_torch.serve.backend import SingleDeviceBackend
    from repro_torch.serve.scheduler import (ContinuousBatchingEngine,
                                             Request, SchedulerConfig)
    spec, params = _model(precision)
    tag = f"[{precision} weights, {cache_dtype} pages]"
    rng = np.random.default_rng(6)
    prompt = torch.zeros((1, 256), dtype=torch.int64, device="cuda")
    prompt[0, :200] = torch.as_tensor(rng.integers(0, spec.vocab_size, 200))
    with torch.no_grad():
        lf, _ = lm.prefill(params, spec, {"tokens": prompt}, impl="pallas",
                           true_len=200)
        ln, _ = lm.prefill(params, spec, {"tokens": prompt}, impl="naive",
                           true_len=200)
    torch.cuda.synchronize()
    err = (lf - ln).abs().max().item()
    scale = max(1.0, ln.abs().max().item())
    log(f"prefill parity {tag}: flash vs sdpa, 200 of 256 tokens, max abs err "
        f"{err:.3e} (logit scale {scale:.3f}, tol {PREFILL_TOL} x scale), argmax "
        f"equal {bool(lf.argmax() == ln.argmax())}")
    if not math.isfinite(err) or err / scale > PREFILL_TOL:
        fail(f"prefill parity {tag}: {err:.3e} > {PREFILL_TOL} x {scale:.3f}")
    lens = [65, 256, 130, 97, 200, 180]
    prompts = [rng.integers(0, spec.vocab_size, size=n).astype(np.int32)
               for n in lens]
    runs = {}
    for impl in ("pallas", "naive"):
        cfg = SchedulerConfig(max_slots=4, page_size=16, max_seq=288,
                              kv_budget_bytes=64e6, cache_dtype=cache_dtype,
                              attention_impl=impl)
        be = SingleDeviceBackend(params, spec, cfg, device="cuda")
        eng = ContinuousBatchingEngine(params, spec, cfg, backend=be)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            done = eng.run([Request(i, p.copy(), 16) for i, p in enumerate(prompts)])
            torch.cuda.synchronize()
        except Exception as exc:  # noqa: BLE001 - reported and fatal
            fail(f"serve flash {tag} attention_impl={impl}: {exc!r}")
        dt = time.perf_counter() - t0
        counts = ops.launch_counts()
        eng.alloc.check()
        if len(done) != len(prompts) or any(
                c.status != "ok" or len(c.tokens) != 16 for c in done):
            fail(f"serve flash {tag} attention_impl={impl}: bad completions")
        want = spec.num_layers * be.cold_admissions if impl == "pallas" else 0
        if counts["flash_attention"] != want or be.cold_admissions < len(prompts):
            fail(f"serve flash {tag} attention_impl={impl}: flash launches "
                 f"{counts['flash_attention']} != {want} ({be.cold_admissions} "
                 "cold admissions)")
        tok = sum(len(c.tokens) for c in done)
        log(f"serve flash {tag} attention_impl={impl}: {tok} tokens in {dt:.3f} s "
            f"= {tok / dt:.1f} tok/s; {be.cold_admissions} cold admissions; "
            f"launches {counts}")
        runs[impl] = ([c.tokens for c in done], counts)
        del eng, be, done
        torch.cuda.empty_cache()
    compare_streams(runs["pallas"][0], runs["naive"][0],
                    f"serve flash {tag}: flash vs sdpa admission")
    return runs["pallas"][1]


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
    attn = qmm = win = flash = None
    if "kernels" in phases:
        attn = phase_kernels_attention(torch, timer, ops, F)
        qmm = phase_kernels_matmul(torch, timer, ops)
        win = phase_kernels_window(torch, timer, ops, F)
        flash = phase_kernels_flash(torch, timer, ops, F)
    if "decode" in phases:
        phase_decode_parity(torch, "int4", "int8")
        phase_decode_parity(torch, "fp32", "int4")
        phase_window_parity(torch, "int4", "int8")
        phase_window_parity(torch, "fp32", "int4")
        phase_step_profile(torch, "int4", "int8")
    launches = {"paged_attention": 0, "paged_window": 0, "quant_matmul": 0,
                "flash_attention": 0}
    if "serve" in phases:
        streams = {}
        for precision, cache_dtype, spec_k in (("int4", "int8", 1),
                                               ("fp32", "int4", 1),
                                               ("int4", "int8", WQ)):
            counts, _, streams[spec_k, precision] = phase_serve(
                torch, ops, precision, cache_dtype, spec_k)
            for k in launches:
                launches[k] += counts[k]
        compare_streams(streams[WQ, "int4"], streams[1, "int4"],
                        f"serve [int4 weights, int8 pages]: spec_k={WQ} vs spec_k=1")
        for phase in (phase_serve_spec_repeating, phase_serve_flash):
            counts = phase(torch, ops, "int4", "int8")
            for k in launches:
                launches[k] += counts[k]
    kernels = []
    if attn is not None:
        a = attn[("int8", "full")]
        m = qmm[(4, 8, 2048, 11264)]
        w = win[("int8", "full")]
        f = flash[(256, 256, 0)]
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
            {"name": "paged_window", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
             "replaces": "src/repro/kernels/paged_attention.py:172",
             "launches": launches["paged_window"], "max_abs_err": w["err"],
             "ms": w["ms"], "plain_ms": w["plain_ms"], "bound_ms": w["bound_ms"],
             "bound_by": w["bound_by"], "library_ms": w["library_ms"]},
            {"name": "flash_attention", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention.py:24",
             "launches": launches["flash_attention"], "max_abs_err": f["err"],
             "ms": f["ms"], "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
             "bound_by": f["bound_by"], "library_ms": f["library_ms"]},
        ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"[smoke] card: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
