#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py kernels,ring    # only the named phases

Phases, each fatal on failure:

1. device: the card, ``nvidia-smi`` name and power limit, torch/CUDA
   versions, and the build of the CUDA kernels from ``csrc/`` (one
   ``nvcc`` per source, all started together);
2. kernels: each kernel against its plain PyTorch version on the card,
   timed with CUDA events beside the bound and one library call, at
   full-width TinyLlama-1.1B shapes (paged attention: fp32/int8/int4
   pools x full/window/ring, B=8, H=32, KV=4, D=64, page 16, ragged
   lengths with a 0, for one query and for a K=4 verify window;
   dequantizing matmul: int8/int4 at M in {1, 8, 32, 128} over the
   model's matmul shapes; flash attention: B=1, causal, Sq=Sk in {128,
   256, 512}, Sq=128 against Sk=256, and a 128-token window) and again
   at Gemma3-1B's (H=4, KV=1, D=256, contexts of 530-950 tokens, window
   512; its projection shapes at M in {8, 32}; flash at Sq=Sk=1024); the
   two attention kernels also at Llama3.2-1B's heads (KV=8, G=4, D=64)
   and DeepSeek-R1-1.5B's (KV=2, G=6, D=128); every paged case also runs
   each slot alone (B=1), which must give bitwise the slot's output in
   the batch;
   quantize: the weight and KV quantizers on the card against the CPU
   (the count of q bytes and scale/zero bits that differ, information
   only while ROADMAP queue 3's fault is open), then ``ops.quantize_rowwise`` at
   M in {8, 32, 256}, K in {1152, 2048, 5632, 6912}, bits 8 and 4,
   byte-exact against the plain version;
3. decode: one full-width ``decode_step_paged`` and one K=4
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
   65-256 tokens, held against the sdpa admission, with each token's
   logits recorded so that one parting may pass as a measured tie
   (``certify_tie``; every other stream comparison has no tie rule);
5. ring: Gemma3-1B at full width cut to its five local layers (a
   uniformly sliding stack), int4 weights, int8 pages: a ring decode
   step and a ring verify window kernels against plain; 8 requests of
   600-750 prompt tokens and ~200 new tokens through the ring and the
   mask-only engine at ``spec_k`` 1 and 4 (streams held against each
   other, the ring bound audited every step, pages recycled in place);
   fp32 pages through the ring held against the static ``generate``;
6. gemma3: all 26 layers of Gemma3-1B on flat tables: a decode step
   kernels against plain and the launcher's paged engine, for int4
   weights with int8 pages and fp32 weights with int4 pages, prompts
   above 512 tokens; flash against sdpa admission on 4 streams;
7. static: ``--engine static`` through the launcher at full-width
   TinyLlama, int4 weights, held against the paged engine (fp32 pages)
   on the same prompts;
8. a ``{"kernels": [...]}`` line, the card's line, and the last line
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

PAGE = 16
# paged-attention cases per model: B slots of H query heads on KV heads of
# dim D, ragged contexts with a 0 (for one query, and for a verify window
# of WQ queries, the contexts then counting the window), a sliding window
# for the window and ring modes, and the flat table width of the serve
# phases.  Gemma3-1B's contexts are those of its ring and gemma3 phases
# (prompts of 520-750 tokens, windows of 512).
TINY = dict(model="TinyLlama-1.1B", B=8, H=32, KV=4, D=64, window=48,
            n_flat=11,                     # pages per slot at max_seq 176
            lengths=[0, 1, 33, 64, 97, 128, 150, 176],
            w_lengths=[0, 4, 37, 68, 101, 132, 154, 176])
GEMMA = dict(model="Gemma3-1B", B=8, H=4, KV=1, D=256, window=512,
             n_flat=61,                    # pages per slot at max_seq 966
             lengths=[0, 1, 530, 611, 687, 750, 873, 950],
             w_lengths=[0, 4, 534, 615, 691, 754, 877, 950])
# the heads of the paper's other two edge models (configs/edge_models.py),
# kernel cases only: contexts of a 512-token serving mix, a 256 window
LLAMA = dict(model="Llama3.2-1B", B=8, H=32, KV=8, D=64, window=256,
             n_flat=33,                    # pages per slot at max_seq 528
             lengths=[0, 1, 97, 200, 313, 402, 477, 512],
             w_lengths=[0, 4, 101, 204, 317, 406, 481, 512])
DEEPSEEK = dict(LLAMA, model="DeepSeek-R1-1.5B", H=12, KV=2, D=128)
WQ = 4                                          # verify window (--spec-k 4)


def _pool(torch, gen, quant: str, P: int, KV: int, D: int):
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
                   K: int = 1, D: int = 64):
    """Pages holding a key the mask accepts for any of the K queries
    (what the kernel reads): the entries of the kernel's split plan."""
    from repro_torch.kernels.paged_attention import split_plan
    (plan,) = split_plan([length], n_entries, PAGE, D, K=K, window=window,
                         ring=ring)
    return sum(len(entries) for _, entries in plan)


def attn_bound(shp, quant, lengths, n_entries, window, ring, K=1):
    """Least time for the paged attention of ``lengths`` (K queries per
    slot, query j at length - K + j): the live pages, q and the output
    once, against 4*D flops per (query head, valid key)."""
    B, H, KV, D = shp["B"], shp["H"], shp["KV"], shp["D"]
    vb = {"none": 4.0, "int8": 1.0, "int4": 0.5}[quant]
    pages = sum(_visited_pages(l, n_entries, window, ring, K, D) for l in lengths)
    per_page = PAGE * KV * D * vb * 2 + (PAGE * KV * 4 * 2 if quant != "none" else 0)
    keys = sum(min(p + 1, window) if window else p + 1
               for l in lengths for p in range(l - K, l) if p >= 0)
    nbytes = pages * per_page + 2 * B * K * H * D * 4 + B * (n_entries + 1) * 4
    flops = 4.0 * H * D * keys
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def phase_kernels_paged(torch, timer, ops, F, shp, K: int = 1):
    """The paged-attention kernel against its plain version at one model's
    head shapes: fp32/int8/int4 pools x full/window/ring tables, one query
    per slot (K = 1, the decode kernel) or a K-token verify window; and
    each slot run alone against the same slot in the batch, bitwise."""
    from repro_torch.kernels.paged_attention import n_splits, split_plan
    gen = torch.Generator(device="cuda").manual_seed(1 if K == 1 else 4)
    B, H, KV, D, W = shp["B"], shp["H"], shp["KV"], shp["D"], shp["window"]
    lengths_l = shp["lengths"] if K == 1 else shp["w_lengths"]
    what = "paged_attention" if K == 1 else f"paged_window K={K}"
    results = {}
    for quant in ("none", "int8", "int4"):
        for mode in ("full", "window", "ring"):
            ring = mode == "ring"
            window = W if mode != "full" else 0
            # a ring holds the window plus the K-1 newer tokens
            n_entries = (-(-(W + K - 1) // PAGE) + 1) if ring else shp["n_flat"]
            P = 1 + B * n_entries
            kp, vp, ks, vs = _pool(torch, gen, quant, P, KV, D)
            perm = torch.randperm(P - 1, generator=gen, device="cuda") + 1
            bt = perm[:B * n_entries].reshape(B, n_entries).to(torch.int32).contiguous()
            lengths = torch.tensor(lengths_l, dtype=torch.int32, device="cuda")
            q = torch.randn((B, H, D) if K == 1 else (B, K, H, D), generator=gen,
                            device="cuda")
            args = (q, kp, vp, bt, lengths)
            kw = dict(window=window, ring=ring, k_scale=ks, v_scale=vs)
            qn = {"none": "fp32"}.get(quant, quant)
            tag = f"{what} {shp['model']} [{qn},{mode}]"
            try:
                out = ops.paged_attention(*args, **kw)
                torch.cuda.synchronize()
            except Exception as exc:  # noqa: BLE001 - reported and fatal
                fail(f"{tag} kernel: {exc}")
            ref = ops.paged_attention(*args, impl="plain", **kw)
            err = (out - ref).abs().max().item()
            scale = max(1.0, ref.abs().max().item())
            if not math.isfinite(err) or err / scale > ATTN_TOL:
                fail(f"{tag} max abs err {err:.3e} > {ATTN_TOL} x {scale:.2f}")
            if not torch.all(out[0] == 0):
                fail(f"{tag}: length-0 slot not zero")
            # batch invariance: every slot alone (B=1, its own table row)
            # gives bitwise the output it has in the batch
            for i in range(B):
                alone = ops.paged_attention(q[i:i + 1], kp, vp, bt[i:i + 1],
                                            lengths[i:i + 1], **kw)
                if not torch.equal(alone, out[i:i + 1]):
                    fail(f"{tag}: slot {i} alone differs from slot {i} in the "
                         f"batch by {(alone - out[i:i + 1]).abs().max().item():.3e}")
            splits = [len(p) for p in split_plan(lengths_l, n_entries, PAGE, D,
                                                 K=K, window=window, ring=ring)]
            ms = timer(lambda: ops.paged_attention(*args, **kw))
            plain_ms = timer(lambda: ops.paged_attention(*args, impl="plain", **kw))
            # library yardstick: SDPA on K/V already gathered and dequantized
            kfull, vfull, mask = _gathered(torch, shp, args, kw, n_entries)
            qs = q[:, :, None, :] if K == 1 else q.transpose(1, 2).contiguous()
            lib_ms = timer(lambda: F.scaled_dot_product_attention(
                qs, kfull, vfull, attn_mask=mask))
            bound_ms, bound_by = attn_bound(shp, quant, lengths_l, n_entries,
                                            window, ring, K)
            log(f"{what} {shp['model']} [{qn:4s} {mode:6s}] err {err:.2e}  "
                f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  sdpa {lib_ms:.4f} "
                f"ms  bound {bound_ms:.5f} ms ({bound_by}); splits per slot "
                f"{splits} of {n_splits(n_entries, PAGE, D)}, each slot bitwise equal alone")
            results[(qn, mode)] = dict(err=err, ms=ms, plain_ms=plain_ms,
                                       library_ms=lib_ms, bound_ms=bound_ms,
                                       bound_by=bound_by)
    return results


def _gathered(torch, shp, args, kw, n_entries):
    """(B, H, S, D) K/V and the (B, 1, K, S) mask the plain version builds
    (K = 1 for a 3-D q), for timing SDPA alone."""
    from repro_torch.kernels import paged_attention as pa
    B, H, KV, D = shp["B"], shp["H"], shp["KV"], shp["D"]
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


# (Sq, Sk, window), causal, B=1: TinyLlama's prompt buckets, and Gemma3's
# 1024-token bucket (prompts of 520-750 tokens) in full and window-512 mode
FLASH_CASES = {
    "TinyLlama-1.1B": [(128, 128, 0), (256, 256, 0), (512, 512, 0),
                       (128, 256, 0), (512, 512, 128)],
    "Gemma3-1B": [(1024, 1024, 0), (1024, 1024, 512)],
    "Llama3.2-1B": [(512, 512, 0), (512, 512, 256)],
    "DeepSeek-R1-1.5B": [(512, 512, 0), (512, 512, 256), (200, 512, 0)]}


def flash_bound(shp, mask, Sq, Sk):
    """q, k, v and the output once; 4*D flops per (query head, key) pair
    the mask keeps (the causal half, the window band)."""
    H, KV, D = shp["H"], shp["KV"], shp["D"]
    pairs = int(mask.sum().item())
    nbytes = 4 * (2 * Sq * H * D + 2 * Sk * KV * D)
    flops = 4.0 * D * H * pairs
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def phase_kernels_flash(torch, timer, ops, F, shp):
    """The flash-attention kernel against its plain version."""
    from repro_torch.kernels.flash_attention import attention_mask
    gen = torch.Generator(device="cuda").manual_seed(5)
    H, KV, D = shp["H"], shp["KV"], shp["D"]
    results = {}
    for Sq, Sk, window in FLASH_CASES[shp["model"]]:
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
        bound_ms, bound_by = flash_bound(shp, mask, Sq, Sk)
        log(f"flash_attention {shp['model']} [Sq {Sq:3d} Sk {Sk:3d} window {window:3d}] err "
            f"{err:.2e}  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  sdpa "
            f"{lib_ms:.4f} ms  bound {bound_ms:.5f} ms ({bound_by})")
        results[(Sq, Sk, window)] = dict(err=err, ms=ms, plain_ms=plain_ms,
                                         library_ms=lib_ms, bound_ms=bound_ms,
                                         bound_by=bound_by)
    return results


# (K, N) of each model's matmuls, per layer in order (wq, wk, wv, wo,
# gate/up, down), then the untied head; the M of decode (8 slots) and of a
# K=4 verify step (32 rows), plus 1 and 128 for TinyLlama
QMM = {
    "TinyLlama-1.1B": dict(
        layers=22, per_layer=[(2048, 2048), (2048, 256), (2048, 256),
                              (2048, 2048), (2048, 11264), (5632, 2048)],
        head=[(2048, 32000)], M=(1, 8, 32, 128)),
    "Gemma3-1B": dict(                     # tied embeddings: no quantized head
        layers=26, per_layer=[(1152, 1024), (1152, 256), (1152, 256),
                              (1024, 1152), (1152, 13824), (6912, 1152)],
        head=[], M=(8, 32)),
}


def qmm_bound(M, K, N, bits):
    wbytes = K * N * (1 if bits == 8 else 0.5)
    sbytes = (N if bits == 8 else (K // 32) * N) * 4
    nbytes = wbytes + sbytes + M * K * 4 + M * N * 4
    flops = 2.0 * M * K * N
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def phase_kernels_matmul(torch, timer, ops, model: str):
    from repro_torch.quant.qtypes import W4_SYM_GROUP, W8_SYM_CHANNEL
    from repro_torch.quant.quantize import dequantize, quantize
    gen = torch.Generator(device="cuda").manual_seed(2)
    cfgs = QMM[model]
    shapes = list(dict.fromkeys(cfgs["per_layer"] + cfgs["head"]))
    results = {}
    for bits, cfg in ((8, W8_SYM_CHANNEL), (4, W4_SYM_GROUP)):
        for K, N in shapes:
            w = quantize(torch.randn((K, N), generator=gen, device="cuda") * 0.02, cfg)
            wf = dequantize(w)
            for M in cfgs["M"]:
                tag = f"quant_matmul {model} [w{bits} M={M} {K}x{N}]"
                x = torch.randn((M, K), generator=gen, device="cuda")
                try:
                    out = ops.quant_matmul(x, w)
                    torch.cuda.synchronize()
                except Exception as exc:  # noqa: BLE001 - reported and fatal
                    fail(f"{tag} kernel: {exc}")
                ref = ops.quant_matmul(x, w, impl="plain")
                err = (out - ref).abs().max().item()
                scale = max(1.0, ref.abs().max().item())
                if not math.isfinite(err) or err / scale > QMM_TOL:
                    fail(f"{tag} max abs err {err:.3e} > {QMM_TOL} x {scale:.2f}")
                ms = timer(lambda: ops.quant_matmul(x, w))
                plain_ms = timer(lambda: ops.quant_matmul(x, w, impl="plain"))
                lib_ms = timer(lambda: torch.matmul(x, wf))
                bound_ms, bound_by = qmm_bound(M, K, N, bits)
                log(f"quant_matmul {model} [w{bits} M={M:3d} {K:5d}x{N:5d}] err "
                    f"{err:.2e}  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                    f"matmul {lib_ms:.4f} ms  bound {bound_ms:.5f} ms ({bound_by})")
                results[(bits, M, K, N)] = dict(err=err, ms=ms, plain_ms=plain_ms,
                                                library_ms=lib_ms, bound_ms=bound_ms,
                                                bound_by=bound_by)
    # one step's matmuls, summed from the cases above
    n = cfgs["layers"] * len(cfgs["per_layer"]) + len(cfgs["head"])
    for bits in (8, 4):
        for M, what in ((8, "decode step"), (32, f"K={WQ} verify step")):
            step = {k: cfgs["layers"] * sum(results[(bits, M, a, b)][k]
                                            for a, b in cfgs["per_layer"])
                    + sum(results[(bits, M, a, b)][k] for a, b in cfgs["head"])
                    for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
            log(f"quant_matmul {model} [w{bits} M={M}] one {what} ({n} launches, "
                f"summed from the cases above): kernel {step['ms']:.3f} ms  plain "
                f"{step['plain_ms']:.3f} ms  matmul {step['library_ms']:.3f} ms  "
                f"bound {step['bound_ms']:.3f} ms")
    return results


# (M, K) of the quantize cases: 8 and 32 activation rows of a decode and a
# verify step, 256 of a prompt, over the two models' activation widths
QUANT_M = (8, 32, 256)
QUANT_K = (1152, 2048, 5632, 6912)


def quantize_bound(M, K):
    """x read once (4 B), q written once (1 B), the scales (4 B a row);
    a few operations a value, far under the card's rate."""
    nbytes = M * K * 4 + M * K + M * 4
    t_b, t_f = nbytes / HBM_BYTES_PER_S, 3.0 * M * K / FP32_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def phase_kernels_quantize(torch, timer, ops):
    """Per-row quantization through its entry point ``ops.quantize_rowwise``
    (its path: no model path calls it in either package), at the models'
    activation shapes, bits 8 and 4.  The entry point's outputs are held
    to the plain version's byte for byte: equal q bytes and bit-identical
    scales.  Returns the cases and the launches of the entry-point run."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    cases = [(bits, M, K) for bits in (8, 4) for M in QUANT_M for K in QUANT_K]
    xs = {c: torch.randn((c[1], c[2]), generator=gen, device="cuda") * 3.0
          for c in cases}
    ops.reset_launch_counts()
    try:
        outs = {c: ops.quantize_rowwise(xs[c], bits=c[0]) for c in cases}
        torch.cuda.synchronize()
    except Exception as exc:  # noqa: BLE001 - reported and fatal
        fail(f"quantize_rowwise kernel: {exc}")
    launches = ops.launch_counts()["quantize_rowwise"]
    if launches != len(cases):
        fail(f"quantize_rowwise: {launches} launches for {len(cases)} calls")
    results = {}
    for c in cases:
        bits, M, K = c
        x = xs[c]
        q, sc = outs[c]
        pq, ps = ops.quantize_rowwise(x, bits=bits, impl="plain")
        bad_q = int((q != pq).sum())
        bad_s = int((sc.view(torch.int32) != ps.view(torch.int32)).sum())
        if q.dtype != torch.int8 or tuple(q.shape) != (M, K) or \
                tuple(sc.shape) != (M, 1) or bad_q or bad_s:
            fail(f"quantize_rowwise [int{bits} M={M} K={K}]: {bad_q} q bytes and "
                 f"{bad_s} scales differ from the plain version")
        err = max((q.int() - pq.int()).abs().max().item(),
                  (sc - ps).abs().max().item())
        ms = timer(lambda: ops.quantize_rowwise(x, bits=bits))
        plain_ms = timer(lambda: ops.quantize_rowwise(x, bits=bits, impl="plain"))
        bound_ms, bound_by = quantize_bound(M, K)
        log(f"quantize_rowwise [int{bits} M={M:3d} K={K:4d}] q bytes and scales "
            f"equal to plain (max abs err {err:.1f})  kernel {ms:.4f} ms  plain "
            f"{plain_ms:.4f} ms  library none  bound {bound_ms:.5f} ms ({bound_by})")
        results[c] = dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                          bound_ms=bound_ms, bound_by=bound_by)
    return results, launches


def phase_quantizers(torch):
    """The weight and KV quantizers of ``quant/quantize.py`` on the card
    against the same calls on the CPU, on the same float inputs: the count
    of q bytes, scale bits and zero-point bits that differ.  Symmetric int8
    channel and int4 group-32 weights, asymmetric int8 tensor and int4
    group-32 weights over both models' matmul shapes, and int8/int4 KV
    rows at both models' head dims.  Information only while ROADMAP queue
    3's open fault stands: the quantizers divide by a Python number, which
    PyTorch computes on a CUDA tensor as a multiply by its rounded
    reciprocal."""
    from repro_torch.quant.qtypes import (A8_ASYM_TENSOR, W4_SYM_GROUP,
                                          W8_SYM_CHANNEL, QuantConfig)
    from repro_torch.quant.quantize import (quantize, quantize_kv_int4,
                                            quantize_kv_int8)
    gen = torch.Generator().manual_seed(11)
    cfgs = {"int8 channel": W8_SYM_CHANNEL, "int4 group32": W4_SYM_GROUP,
            "asym int8 tensor": A8_ASYM_TENSOR,
            "asym int4 group32": QuantConfig(bits=4, symmetric=False,
                                             granularity="group", group_size=32)}
    cases = []
    for model, q in QMM.items():
        for K, N in dict.fromkeys(q["per_layer"]):
            x = torch.randn((K, N), generator=gen) * 0.02
            for name, cfg in cfgs.items():
                cases.append((f"{model} {name} {K}x{N}", x,
                              lambda t, cfg=cfg: quantize(t, cfg)))
    for shp in (TINY, GEMMA):
        x = torch.randn((256, shp["KV"], shp["D"]), generator=gen) * 3.0
        for bits, fn in ((8, quantize_kv_int8), (4, quantize_kv_int4)):
            cases.append((f"{shp['model']} KV rows int{bits} D={shp['D']}", x,
                          lambda t, fn=fn: dict(zip(("q", "scale"), fn(t)))))

    def parts(r):
        r = r if isinstance(r, dict) else dict(q=r.q, scale=r.scale, zero=r.zero)
        return {k: v for k, v in r.items() if v is not None}

    differ = {"q": [0, 0], "scale": [0, 0], "zero": [0, 0]}   # differing, all
    for tag, x, fn in cases:
        want = parts(fn(x))
        got = {k: v.cpu() for k, v in parts(fn(x.cuda())).items()}
        for k in want:
            a, b = want[k], got[k]
            if a.shape != b.shape:
                fail(f"quantizer {tag}: {k} shapes {tuple(a.shape)} on the CPU, "
                     f"{tuple(b.shape)} on the card")
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            differ[k][0] += int((a != b).sum())
            differ[k][1] += a.numel()
    log(f"quantizers: {len(cases)} cases, card against CPU: "
        + ", ".join(f"{k} {n} of {m} differ" for k, (n, m) in differ.items())
        + " (information only: ROADMAP queue 3's open fault)")


# ---------------------------------------------------------------------------
# phase 3: full-width decode step, kernels vs plain
# ---------------------------------------------------------------------------

def _spec(arch: str = ARCH, layers: int = 0):
    """A model's spec at full width, its depth cut to ``layers`` if set."""
    from repro_torch.configs import ARCHS
    spec = ARCHS[arch]
    return spec.with_(num_layers=layers) if layers else spec


def _model(precision: str, spec=None):
    from repro_torch.models import lm
    from repro_torch.quant.qlinear import quantize_params
    spec = spec or _spec()
    params = lm.init(0, spec, device="cuda")
    if precision != "fp32":
        params = quantize_params(params, precision)
    return spec, params


def _admitted_backend(torch, precision: str, cache_dtype: str, spec=None,
                      plens=(32, 129), entries: int = 11, spec_k: int = 1,
                      windowed_kv=None):
    """A full-width backend with 8 slots cold-admitted (prompts of
    ``plens`` tokens) and their first tokens (8, 1).  Flat tables of
    ``entries`` pages hold the prompt and one spare page; a uniformly
    sliding stack gets ring tables of ``ring_pages(window, 16, spec_k)``
    entries instead, every entry its own page."""
    import numpy as np
    from repro_torch.serve.backend import SingleDeviceBackend
    from repro_torch.serve.scheduler import SchedulerConfig
    spec, params = _model(precision, spec)
    cfg = SchedulerConfig(max_slots=8, page_size=16, max_seq=16 * entries,
                          num_pages=1 + 8 * entries, cache_dtype=cache_dtype,
                          spec_k=spec_k, windowed_kv=windowed_kv)
    be = SingleDeviceBackend(params, spec, cfg, device="cuda")
    R = be.cache["block_tables"].shape[1]
    rng = np.random.default_rng(3)
    first = []
    for slot in range(8):
        plen = int(rng.integers(*plens))
        n_pages = -(-plen // 16)
        bucket = 16
        while bucket < plen:
            bucket *= 2
        if not be.ring:
            bucket = min(bucket, 16 * R)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :plen] = rng.integers(0, spec.vocab_size, size=plen)
        row = np.zeros((R,), np.int32)
        n = R if be.ring else n_pages + 1
        row[:n] = 1 + slot * R + np.arange(n)
        first.append(be.admit_full(padded, slot, plen, row))
    tokens = torch.tensor(first, dtype=torch.int64, device="cuda")[:, None]
    return be, spec, tokens


def _tag(be, spec, precision, cache_dtype):
    table = f"ring of {be.cache['block_tables'].shape[1]}" if be.ring else "flat"
    return (f"[{spec.name} {spec.num_layers} layers, {precision} weights, "
            f"{cache_dtype} pages, {table} tables]")


def phase_decode_parity(torch, precision: str, cache_dtype: str, **admit):
    """One full-width decode step from one paged cache state through the
    kernels against the plain versions (``admit``: the model and its
    tables, see ``_admitted_backend``); then the step's host wall time."""
    from repro_torch.models import lm
    be, spec, tokens = _admitted_backend(torch, precision, cache_dtype, **admit)
    tag = _tag(be, spec, precision, cache_dtype)
    cache_k = copy.deepcopy(be.cache)
    cache_p = copy.deepcopy(be.cache)
    with torch.no_grad():
        lk, _ = lm.decode_step_paged(be.params, spec, cache_k, tokens,
                                     ring=be.ring)
        lp, _ = lm.decode_step_paged(be.params, spec, cache_p, tokens,
                                     ring=be.ring, impl="plain")
    torch.cuda.synchronize()
    if tuple(lk.shape) != (8, 1, spec.padded_vocab) or not torch.all(torch.isfinite(lk)):
        fail(f"decode logits {tag}: shape {tuple(lk.shape)} or non-finite values")
    err = (lk - lp).abs().max().item()
    scale = max(1.0, lp.abs().max().item())
    tol = DECODE_TOL[cache_dtype if cache_dtype != "fp32" else "int8"]
    match = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
    log(f"decode parity {tag}: kernels vs plain max abs err {err:.3e} (logit "
        f"scale {scale:.3f}, tol {tol} x scale), argmax match {match:.3f} "
        "(information only)")
    if not math.isfinite(err) or err / scale > tol:
        fail(f"decode parity {tag} {err:.3e} > {tol} x {scale:.3f}")
    # host wall time of a full-width decode step (8 slots) through the
    # kernels, after the step above warmed everything up
    n = 5
    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(n):
            lm.decode_step_paged(be.params, spec, cache_k, tokens, ring=be.ring)
    torch.cuda.synchronize()
    log(f"decode step wall {tag}: "
        f"{(time.perf_counter() - t0) * 1e3 / n:.2f} ms per step (host clock, "
        f"mean of {n}, 8 slots)")
    del be, cache_k, cache_p
    torch.cuda.empty_cache()


def phase_window_parity(torch, precision: str, cache_dtype: str, **admit):
    """One K=4 verify window at full width from one cache state, through
    the kernels against the plain versions (ragged lens); then a window
    of greedy tokens against the K sequential decode steps it replaces,
    and the backend's fused verify step fed those greedy drafts, which
    must accept them on the device.  ``admit`` as in
    ``phase_decode_parity`` (a ring backend is sized for ``spec_k=4``)."""
    import numpy as np
    from repro_torch.models import lm
    be, spec, tokens = _admitted_backend(torch, precision, cache_dtype,
                                         spec_k=WQ, **admit)
    ring = be.ring
    cache0 = copy.deepcopy(be.cache)
    tol = DECODE_TOL[cache_dtype if cache_dtype != "fp32" else "int8"]
    tag = _tag(be, spec, precision, cache_dtype)
    rng = np.random.default_rng(5)
    drafts = torch.tensor(rng.integers(0, spec.vocab_size, size=(8, WQ - 1)),
                          dtype=torch.int64, device="cuda")
    window = torch.cat([tokens, drafts], dim=1)
    lens = torch.tensor([4, 4, 3, 2, 1, 4, 4, 4], dtype=torch.int32, device="cuda")
    cache_k = copy.deepcopy(be.cache)
    cache_p = copy.deepcopy(be.cache)
    with torch.no_grad():
        lk, _ = lm.decode_window_paged(be.params, spec, cache_k, window, lens,
                                       ring=ring)
        lp, _ = lm.decode_window_paged(be.params, spec, cache_p, window, lens,
                                       ring=ring, impl="plain")
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
            l, seq = lm.decode_step_paged(be.params, spec, seq, toks[-1],
                                          ring=ring)
            seq_logits.append(l[:, 0])
            toks.append(l[:, 0].argmax(-1)[:, None])
        full = torch.full((8,), WQ, dtype=torch.int32, device="cuda")
        wl, _ = lm.decode_window_paged(be.params, spec, win,
                                       torch.cat(toks[:WQ], dim=1), full,
                                       ring=ring)
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


def _profile_in_turns(torch, cases, tag):
    """Host wall time and device busy time of backend decode calls,
    ``cases``: name -> (backend, cache state to start from, decode
    arguments).  On a host shared with other work the host-side time can
    drift by 2x within one run, so the cases are timed in turns (median
    of 6 each, after one round of warm-up).  Information only."""
    import numpy as np
    walls = {name: [] for name in cases}
    for _ in range(7):                 # the first round warms up
        for name, (be, cache0, args) in cases.items():
            be.cache = copy.deepcopy(cache0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            be.decode(*args)           # ends in a device-to-host copy
            walls[name].append((time.perf_counter() - t0) * 1e3)
    for name, (be, cache0, args) in cases.items():
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


def phase_step_profile(torch, precision: str, cache_dtype: str, **admit):
    """A K=1 step against a K=4 verify step (random drafts) on one
    full-width backend with 8 slots (``admit`` as in
    ``phase_decode_parity``), timed in turns.  Information only."""
    import numpy as np
    be, spec, tokens = _admitted_backend(torch, precision, cache_dtype,
                                         spec_k=WQ, **admit)
    cache0 = copy.deepcopy(be.cache)
    tok1 = tokens.cpu().numpy().astype(np.int32)
    rng = np.random.default_rng(9)
    window = np.concatenate(
        [tok1, rng.integers(0, spec.vocab_size, size=(8, WQ - 1))], axis=1
    ).astype(np.int32)
    act = np.ones(8, np.int32)
    _profile_in_turns(torch, {
        "K=1 decode step": (be, cache0, (tok1, act)),
        f"K={WQ} verify step": (be, cache0, (window, act, np.full(8, WQ, np.int32)))},
        _tag(be, spec, precision, cache_dtype))
    del be, cache0
    torch.cuda.empty_cache()


def phase_ring_step_profile(torch, precision: str, cache_dtype: str, spec):
    """A K=1 step on ring tables against the same step on the mask-only
    engine's flat tables, from the same 8 admitted prompts of 600-750
    tokens, timed in turns.  Information only."""
    import numpy as np
    cases = {}
    for what, wkv, entries in (("ring", None, 34), ("mask-only", False, 64)):
        be, spec, tokens = _admitted_backend(
            torch, precision, cache_dtype, spec=spec, plens=(600, 751),
            entries=entries, windowed_kv=wkv)
        cases[f"K=1 decode step, {what} {_tag(be, spec, precision, cache_dtype)}"] = (
            be, copy.deepcopy(be.cache),
            (tokens.cpu().numpy().astype(np.int32), np.ones(8, np.int32)))
    _profile_in_turns(torch, cases, "(ring phase)")
    del cases
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


def certify_tie(la, lb, step: int, tok_a: int, tok_b: int,
                tol: float = PREFILL_TOL):
    """Whether two greedy streams of two attention programs that agree up
    to ``step`` and part there (``tok_a`` against ``tok_b``) parted on a
    tie of the logits, measured: ``la``/``lb`` are each run's logits (one
    row per token of the stream, the row each token was the argmax of).
    Certified only if (a) at ``step`` the measured ``max |la - lb|`` over
    the vocabulary is within ``tol * max(1, max |lb|)``, (b) so was it at
    every earlier step, and (c) the two tokens are the top two of both
    rows.  Returns (certified, facts); no bound fixed in advance enters."""
    import numpy as np
    n = min(len(la), len(lb))
    diffs, bands = [], []
    for t in range(min(step + 1, n)):
        a, b = np.asarray(la[t], np.float64), np.asarray(lb[t], np.float64)
        diffs.append(float(np.max(np.abs(a - b))))
        bands.append(tol * max(1.0, float(np.max(np.abs(b)))))
    facts = dict(step=step, tok_a=int(tok_a), tok_b=int(tok_b),
                 gap_a=float("nan"), gap_b=float("nan"), diff=float("nan"),
                 band=float("nan"), worst_earlier=None)
    if step >= n:
        return False, facts
    tops = []
    for row, key in ((la[step], "gap_a"), (lb[step], "gap_b")):
        row = np.asarray(row)
        i1, i2 = (int(i) for i in np.argsort(row, kind="stable")[::-1][:2])
        facts[key] = float(row[i1]) - float(row[i2])
        tops.append({i1, i2})
    facts["diff"], facts["band"] = diffs[step], bands[step]
    over = [t for t in range(step) if diffs[t] > bands[t]]
    facts["worst_earlier"] = over[0] if over else None
    certified = (diffs[step] <= bands[step] and not over and tok_a != tok_b
                 and tops[0] == tops[1] == {int(tok_a), int(tok_b)})
    return certified, facts


def tie_ratios(a, b, la, lb, tol: float = PREFILL_TOL):
    """Per stream, the largest measured ``max |la - lb| / (tol * max(1,
    max |lb|))`` over its steps up to and including its parting (all its
    steps if it does not part): how near the two runs' logits stay to the
    tie band.  Information only."""
    import numpy as np
    out = []
    for x, y, ra, rb in zip(a, b, la, lb):
        x, y = np.asarray(x).ravel(), np.asarray(y).ravel()
        m = min(len(x), len(y), len(ra), len(rb))
        neq = np.nonzero(x[:m] != y[:m])[0]
        end = int(neq[0]) + 1 if len(neq) else m
        out.append(round(max(
            (float(np.max(np.abs(np.asarray(p, np.float64) - q)))
             / (tol * max(1.0, float(np.max(np.abs(q)))))
             for p, q in zip(ra[:end], rb[:end])), default=0.0), 3))
    return out


def judge_partings(a, b, la, lb, tol: float = PREFILL_TOL,
                   min_frac: float = 0.9):
    """The stream gate between two attention programs: every stream must
    hold the ``assert_close_tokens`` band (matching prefix >= ``min_frac``)
    but for at most one parting that ``certify_tie`` certifies.  Partings
    are judged in stream order; a second parting that would certify is
    refused.  Returns (one report line per parting, the streams that
    fail)."""
    import numpy as np
    sys.path.insert(0, str(ROOT / "tests"))
    from tolerance import token_match_fraction
    lines, failed, tied = [], [], False
    for i, (x, y) in enumerate(zip(a, b)):
        x, y = np.asarray(x).ravel(), np.asarray(y).ravel()
        if np.array_equal(x, y):
            continue
        m = min(len(x), len(y))
        neq = np.nonzero(x[:m] != y[:m])[0]
        frac = token_match_fraction(x, y)
        if not len(neq):
            lines.append(f"stream {i}: lengths {len(x)} / {len(y)}, no parting "
                         "token (band only)")
            failed += [i] if frac < min_frac else []
            continue
        step = int(neq[0])
        ok, f = certify_tie(la[i], lb[i], step, x[step], y[step], tol)
        if ok and not tied:
            tied, verdict = True, "certified tie"
        elif ok:
            verdict = "refused: a second tie in one phase (band only)"
        else:
            why = []
            if not f["diff"] <= f["band"]:
                why.append("the measured difference exceeds the band")
            if f["worst_earlier"] is not None:
                why.append(f"step {f['worst_earlier']} exceeded the band")
            if not why:
                why.append("the tokens are not the top two of both rows")
            verdict = f"not a tie: {'; '.join(why)} (band only)"
        if verdict != "certified tie" and frac < min_frac:
            failed.append(i)
        lines.append(
            f"stream {i} parts at step {step}: tokens {f['tok_a']} / "
            f"{f['tok_b']}, top-2 gaps {f['gap_a']:.3e} / {f['gap_b']:.3e}, "
            f"measured max |l_a - l_b| {f['diff']:.3e}, band {f['band']:.3e} "
            f"({tol} x scale); matching prefix {frac:.3f}: {verdict}")
    return lines, failed


def compare_streams(a, b, what: str, logits=None) -> None:
    """Greedy streams of two runs: the exact-match fraction, and a fatal
    check against the ``assert_close_tokens`` band of tests/tolerance.py
    (matching prefix >= 0.9 of each stream).  Only two attention programs
    (flash against sdpa admission) pass ``logits``, each run's per-token
    logit rows by stream: there one parting may pass as a measured tie
    (``judge_partings``)."""
    import numpy as np
    sys.path.insert(0, str(ROOT / "tests"))
    from tolerance import token_match_fraction
    fracs = [token_match_fraction(x, y) for x, y in zip(a, b)]
    exact = sum(bool(np.array_equal(x, y)) for x, y in zip(a, b)) / len(a)
    log(f"{what}: exact-match fraction {exact:.3f} of {len(a)} streams; "
        f"matching-prefix fractions {[round(f, 3) for f in fracs]}")
    if len(a) != len(b):
        fail(f"{what}: {len(a)} streams against {len(b)}")
    if logits is None:
        if min(fracs) < 0.9:
            fail(f"{what}: streams diverge below the 0.9 matching-prefix band")
        return
    lines, failed = judge_partings(a, b, *logits)
    log(f"{what}: measured max |l_a - l_b| / ({PREFILL_TOL} x scale) over each "
        f"stream's steps up to its parting: {tie_ratios(a, b, *logits)}")
    for line in lines:
        log(f"{what}: {line}")
    if failed:
        fail(f"{what}: streams {failed} diverge below the 0.9 matching-prefix "
             "band and are no certified tie")


class LogitTape:
    """Records, by request, the logit row each token of its greedy stream
    was the argmax of: the cold admission's ``lm.prefill`` row for its
    first token and its row of every K=1 ``lm.decode_step_paged`` after.
    The smoke wraps those two model calls (and the backend methods that
    make them, for the slot of each row) while an engine runs; the port's
    API does not change."""

    def __init__(self, lm, eng, be):
        self.lm, self.eng, self.be = lm, eng, be
        self.rows = {}          # uid -> [np.ndarray (vocab,)]
        self._pending = []      # (slot, row) of admissions not yet bound
        self._last = {}

    def __enter__(self):
        lm, be, last = self.lm, self.be, self._last
        self._saved = (lm.prefill, lm.decode_step_paged, be.admit_full, be.decode)
        prefill, decode_step, admit_full, decode = self._saved

        def keep(name, fn):
            def call(*args, **kw):
                logits, rest = fn(*args, **kw)
                last[name] = logits
                return logits, rest
            return call

        def admit(padded, slot, true_len, row):
            tok = admit_full(padded, slot, true_len, row)
            self._pending.append((slot, last.pop("prefill")[0, 0].float().cpu().numpy()))
            return tok

        def step(tokens, active, lens=None):
            if lens is not None:
                raise RuntimeError("LogitTape records K=1 decode steps only")
            self._bind()
            out = decode(tokens, active)
            rows = last.pop("decode")[:, 0].float().cpu().numpy()
            for i, on in enumerate(active):
                if on:
                    self.rows.setdefault(self.eng.slots[i].uid, []).append(rows[i])
            return out

        lm.prefill, lm.decode_step_paged = keep("prefill", prefill), keep("decode", decode_step)
        be.admit_full, be.decode = admit, step
        return self

    def _bind(self):
        for slot, row in self._pending:
            self.rows.setdefault(self.eng.slots[slot].uid, []).append(row)
        self._pending.clear()

    def __exit__(self, *exc):
        self._bind()
        self.lm.prefill, self.lm.decode_step_paged = self._saved[:2]
        del self.be.admit_full, self.be.decode   # back to the class's methods
        return False


def phase_serve_flash(torch, ops, precision: str, cache_dtype: str,
                      spec=None, lens=(65, 256, 130, 97, 200, 180),
                      one=(200, 256), new: int = 16):
    """Cold admission through the flash kernel at the library boundary:
    ``ContinuousBatchingEngine(params, spec, SchedulerConfig(...,
    attention_impl="pallas"))``, prompts of ``lens`` tokens (TinyLlama:
    65-256, bucketed to 128 or 256), ``new`` new tokens each; streams
    held against the sdpa admission of the same requests.  First, one
    full-width prompt's logits through flash against sdpa (``one``: its
    true and padded length)."""
    import numpy as np
    from repro_torch.models import lm
    from repro_torch.serve.backend import SingleDeviceBackend
    from repro_torch.serve.scheduler import (ContinuousBatchingEngine,
                                             Request, SchedulerConfig)
    spec, params = _model(precision, spec)
    tag = f"[{spec.name} {spec.num_layers} layers, {precision} weights, {cache_dtype} pages]"
    rng = np.random.default_rng(6)
    true_len, padded = one
    prompt = torch.zeros((1, padded), dtype=torch.int64, device="cuda")
    prompt[0, :true_len] = torch.as_tensor(rng.integers(0, spec.vocab_size, true_len))
    with torch.no_grad():
        lf, _ = lm.prefill(params, spec, {"tokens": prompt}, impl="pallas",
                           true_len=true_len)
        ln, _ = lm.prefill(params, spec, {"tokens": prompt}, impl="naive",
                           true_len=true_len)
    torch.cuda.synchronize()
    err = (lf - ln).abs().max().item()
    scale = max(1.0, ln.abs().max().item())
    log(f"prefill parity {tag}: flash vs sdpa, {true_len} of {padded} tokens, max "
        f"abs err {err:.3e} (logit scale {scale:.3f}, tol {PREFILL_TOL} x scale), "
        f"argmax equal {bool(lf.argmax() == ln.argmax())}")
    if not math.isfinite(err) or err / scale > PREFILL_TOL:
        fail(f"prefill parity {tag}: {err:.3e} > {PREFILL_TOL} x {scale:.3f}")
    del lf, ln
    prompts = [rng.integers(0, spec.vocab_size, size=n).astype(np.int32)
               for n in lens]
    max_seq = -(-(max(lens) + new) // 16) * 16 + 16
    runs, tapes = {}, {}
    for impl in ("pallas", "naive"):
        cfg = SchedulerConfig(max_slots=4, page_size=16, max_seq=max_seq,
                              num_pages=1 + 4 * (max_seq // 16),
                              cache_dtype=cache_dtype, attention_impl=impl)
        be = SingleDeviceBackend(params, spec, cfg, device="cuda")
        eng = ContinuousBatchingEngine(params, spec, cfg, backend=be)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            with LogitTape(lm, eng, be) as tape:
                done = eng.run([Request(i, p.copy(), new)
                                for i, p in enumerate(prompts)])
                torch.cuda.synchronize()
        except Exception as exc:  # noqa: BLE001 - reported and fatal
            fail(f"serve flash {tag} attention_impl={impl}: {exc!r}")
        dt = time.perf_counter() - t0
        counts = ops.launch_counts()
        tapes[impl] = [tape.rows.get(c.uid, []) for c in done]
        if any(len(r) != len(c.tokens) or any(int(np.argmax(x)) != int(t)
                                               for x, t in zip(r, c.tokens))
               for r, c in zip(tapes[impl], done)):
            fail(f"serve flash {tag} attention_impl={impl}: the recorded logit "
                 "rows do not give the streams' tokens")
        eng.alloc.check()
        if len(done) != len(prompts) or any(
                c.status != "ok" or len(c.tokens) != new for c in done):
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
                    f"serve flash {tag}: flash vs sdpa admission",
                    logits=(tapes["pallas"], tapes["naive"]))
    return runs["pallas"][1]


# ---------------------------------------------------------------------------
# phase 5: ring-paged serving of Gemma3-1B's local layers
# ---------------------------------------------------------------------------

RING_LAYERS = 5          # Gemma3-1B's first five layers are all attn_local


def _drive(torch, ops, spec, params, cfg, reqs, tag):
    """Run an engine over ``reqs`` step by step with the launch counts
    reset just before and read just after; fatal unless every request
    completes with its token count.  Returns the streams, the counts,
    the engine, its backend, the most pages any slot held after a step,
    and the seconds (host clock)."""
    from repro_torch.serve.backend import SingleDeviceBackend
    from repro_torch.serve.scheduler import ContinuousBatchingEngine
    be = SingleDeviceBackend(params, spec, cfg, device="cuda")
    eng = ContinuousBatchingEngine(params, spec, cfg, backend=be)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    held = 0
    try:
        for r in reqs:
            eng.submit(r)
        done = []
        while eng.queue or eng.num_active:
            done.extend(eng.step())
            held = max([held] + [len(sl.pages) for sl in eng.slots if sl is not None])
        torch.cuda.synchronize()
    except Exception as exc:  # noqa: BLE001 - reported and fatal
        fail(f"{tag}: {exc!r}")
    dt = time.perf_counter() - t0
    counts = ops.launch_counts()
    eng.alloc.check()
    done = sorted(done, key=lambda c: c.uid)
    want = {r.uid: r.max_new_tokens for r in reqs}
    bad = [c.uid for c in done if c.status != "ok" or len(c.tokens) != want[c.uid]]
    if len(done) != len(reqs) or bad:
        fail(f"{tag}: {len(done)} completions, bad {bad}")
    if any(int(t) < 0 or int(t) >= spec.padded_vocab for c in done for t in c.tokens):
        fail(f"{tag}: token id out of range")
    return [c.tokens for c in done], counts, eng, be, held, dt


def phase_ring(torch, ops):
    """``gemma3-1b`` at full width with its depth cut to its five local
    layers (the one uniformly sliding stack of full width in the repo),
    int4 weights, int8 pages of 16 tokens, 8 requests of 600-750 prompt
    tokens and 190-210 new tokens each, so every slot wraps its ring of
    ``ring_pages(512, 16, spec_k)`` entries.  ``spec_k`` 1 and 4, each
    through the ring and through the mask-only engine
    (``windowed_kv=False``), whose streams the ring's must match; then
    fp32 pages through the ring against the static ``generate`` of the
    same prompts.  ``debug_invariants`` audits the ring bound after every
    step.  Before the serve runs: one ring decode step and one ring verify
    window, kernels against plain."""
    import numpy as np
    from repro_torch.serve import paged_cache as pc
    from repro_torch.serve.engine import ServeConfig, generate
    from repro_torch.serve.scheduler import Request, SchedulerConfig
    spec = _spec("gemma3-1b", RING_LAYERS)
    if set(spec.layer_kinds()) != {"attn_local"}:
        fail(f"ring: {spec.name} at {RING_LAYERS} layers is not uniformly local")
    admit = dict(spec=spec, plens=(600, 751), entries=34)
    phase_decode_parity(torch, "int4", "int8", **admit)
    phase_window_parity(torch, "int4", "int8", **admit)
    phase_ring_step_profile(torch, "int4", "int8", spec)
    W = spec.sliding_window
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, spec.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(600, 751, size=8)]
    new = [int(n) for n in rng.integers(190, 211, size=8)]
    max_seq = -(-(750 + 210) // 16) * 16 + 16
    launches = {}
    streams = {}
    for precision, cache_dtype, spec_k, wkv in (
            ("int4", "int8", 1, None), ("int4", "int8", 1, False),
            ("int4", "int8", WQ, None), ("int4", "int8", WQ, False),
            ("fp32", "fp32", 1, None)):
        _, params = _model(precision, spec)
        cfg = SchedulerConfig(max_slots=8, page_size=16, max_seq=max_seq,
                              num_pages=1 + 8 * (max_seq // 16),
                              cache_dtype=cache_dtype, spec_k=spec_k,
                              windowed_kv=wkv, debug_invariants=True)
        kind = "ring" if wkv is None else "mask-only"
        tag = (f"ring phase [{spec.name} {RING_LAYERS} layers, {precision} "
               f"weights, {cache_dtype} pages, spec_k={spec_k}, {kind}]")
        out, counts, eng, be, held, dt = _drive(
            torch, ops, spec, params, cfg,
            [Request(i, p.copy(), n) for i, (p, n) in enumerate(zip(prompts, new))],
            tag)
        st = eng.stats
        R = pc.ring_pages(W, 16, spec_k)
        width = be.cache["block_tables"].shape[1]
        if wkv is None and not (eng.ring and eng.window == W and width == R
                                and held <= R and st["ring_recycled_pages"] > 0):
            fail(f"{tag}: ring {eng.ring}, window {eng.window}, {width} entries "
                 f"(ring_pages {R}), {held} pages held, "
                 f"{int(st['ring_recycled_pages'])} recycled")
        if wkv is False and (eng.ring or st["ring_recycled_pages"]):
            fail(f"{tag}: the mask-only engine ran a ring")
        attn, other = (("paged_attention", "paged_window") if spec_k == 1
                       else ("paged_window", "paged_attention"))
        if counts[attn] != RING_LAYERS * be.decode_steps or counts[attn] == 0 \
                or counts[other]:
            fail(f"{tag}: {attn} launches {counts[attn]} != {RING_LAYERS} x "
                 f"{be.decode_steps} decode steps, or {other} launched "
                 f"{counts[other]} times")
        if precision == "int4" and counts["quant_matmul"] == 0:
            fail(f"{tag}: the dequantizing matmul never launched")
        tok = sum(len(t) for t in out)
        log(f"{tag}: {tok} tokens in {dt:.3f} s = {tok / dt:.1f} tok/s; "
            f"{be.decode_steps} decode steps ({dt * 1e3 / be.decode_steps:.2f} ms "
            f"per step, host clock, admissions included); tables {width} entries "
            f"(ring_pages {R}), most pages held by a slot {held}, recycled in "
            f"place {int(st['ring_recycled_pages'])}, shared released "
            f"{int(st['ring_shared_released'])}, preemptions "
            f"{int(st['preemptions'])}; spec windows {int(st['spec_steps'])}; "
            f"launches {counts}")
        streams[precision, spec_k, kind] = out
        if kind == "ring":
            for k in counts:
                launches[k] = launches.get(k, 0) + counts[k]
        del eng, be, params
        torch.cuda.empty_cache()
    for spec_k in (1, WQ):
        compare_streams(streams["int4", spec_k, "ring"],
                        streams["int4", spec_k, "mask-only"],
                        f"ring phase spec_k={spec_k}: ring vs mask-only engine")
    # the static engine's contiguous f32 cache against fp32 ring pages
    _, params = _model("fp32", spec)
    t0 = time.perf_counter()
    static = []
    for p, n in zip(prompts, new):
        out = generate(params, spec, {"tokens": torch.as_tensor(
            p[None], dtype=torch.int64, device="cuda")}, n - 1,
            ServeConfig(max_seq=len(p) + n, attention_impl="naive"))
        static.append(out["tokens"][0].cpu().numpy())
    log(f"ring phase: static generate of the 8 requests, one at a time, "
        f"{time.perf_counter() - t0:.3f} s (host clock)")
    compare_streams(streams["fp32", 1, "ring"], static,
                    "ring phase fp32 pages: ring engine vs static generate")
    del params
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 6: Gemma3-1B at full depth on flat tables
# ---------------------------------------------------------------------------

def phase_gemma3(torch, ops):
    """All 26 layers of ``gemma3-1b`` (21 local layers masking a 512-token
    window, 5 global; head_dim 256, one KV head, tied 262144-token
    embeddings) on flat tables: one decode step kernels against plain
    for int4 weights with int8 pages and fp32 weights with int4 pages,
    prompts of 520-750 tokens; the launcher serving 8 requests of 520-600
    prompt tokens for both; flash against sdpa admission on 4 streams
    (int4 weights, fp32 pages)."""
    from repro_torch.launch import serve
    spec = _spec("gemma3-1b")
    phase_step_profile(torch, "int4", "int8", spec=spec, plens=(520, 751),
                       entries=64)
    launches = {}
    for precision, cache_dtype in (("int4", "int8"), ("fp32", "int4")):
        phase_decode_parity(torch, precision, cache_dtype, spec=spec,
                            plens=(520, 751), entries=64)
        argv = ["--engine", "paged", "--arch", "gemma3-1b", "--precision",
                precision, "--cache-dtype", cache_dtype, "--batch", "8",
                "--prompt-len", "600", "--min-prompt-len", "520", "--steps", "24",
                "--device", "cuda"]
        tag = f"gemma3 serve [{precision} weights, {cache_dtype} pages]"
        ops.reset_launch_counts()
        try:
            res = serve.main(argv)
            torch.cuda.synchronize()
        except Exception as exc:  # noqa: BLE001 - reported and fatal
            fail(f"{tag}: {exc!r}")
        counts = ops.launch_counts()
        eng, done = res["engine"], res["completions"]
        eng.alloc.check()
        if eng.ring or eng.spec.num_layers != spec.num_layers:
            fail(f"{tag}: expected flat tables over {spec.num_layers} layers")
        bad = [c.uid for c in done if c.status != "ok" or len(c.tokens) != 24]
        if len(done) != 8 or bad:
            fail(f"{tag}: {len(done)} completions, bad {bad}")
        steps = res["decode_steps"]
        if counts["paged_attention"] != spec.num_layers * steps or steps == 0:
            fail(f"{tag}: paged_attention launches {counts['paged_attention']} "
                 f"!= {spec.num_layers} x {steps} decode steps")
        if (precision == "int4") != (counts["quant_matmul"] > 0):
            fail(f"{tag}: quant_matmul launches {counts['quant_matmul']}")
        log(f"{tag}: {res['tokens']} tokens in {res['seconds']:.3f} s = "
            f"{res['tokens_per_s']:.1f} tok/s; {steps} decode steps "
            f"({res['seconds'] * 1e3 / steps:.2f} ms per step, host clock, "
            f"admissions included); preemptions "
            f"{int(eng.stats['preemptions'])}; launches {counts}")
        for k in counts:
            launches[k] = launches.get(k, 0) + counts[k]
        del res, eng, done
        torch.cuda.empty_cache()
    # fp32 pages: the comparison is of the two admissions' attention, and
    # int8 pages would round their last-bit differences into whole code
    # steps of the cached K/V, which a greedy near-tie then turns into
    # different streams
    counts = phase_serve_flash(torch, ops, "int4", "fp32", spec=spec,
                               lens=(530, 750, 612, 688), one=(700, 1024), new=8)
    for k in counts:
        launches[k] = launches.get(k, 0) + counts[k]
    return launches


# ---------------------------------------------------------------------------
# phase 7: the static engine through the launcher
# ---------------------------------------------------------------------------

def phase_static(torch, ops):
    """``--engine static`` at full-width TinyLlama, int4 weights: 8
    prompts of 128 tokens, 32 decode steps through the contiguous cache.
    Its greedy streams are held against the paged engine's (fp32 pages,
    same weights) on the same prompts."""
    from repro_torch.launch import serve
    from repro_torch.serve.scheduler import Request, SchedulerConfig
    tag = "static [TinyLlama-1.1B, int4 weights]"
    ops.reset_launch_counts()
    try:
        res = serve.main(["--engine", "static", "--arch", ARCH, "--precision",
                          "int4", "--batch", "8", "--prompt-len", "128",
                          "--steps", "32", "--device", "cuda"])
        torch.cuda.synchronize()
    except Exception as exc:  # noqa: BLE001 - reported and fatal
        fail(f"{tag}: {exc!r}")
    counts = ops.launch_counts()
    tokens, prompts = res["tokens"], res["prompts"]
    spec, params = _model("int4")
    if tokens.shape != (8, 33) or tokens.min() < 0 or tokens.max() >= spec.padded_vocab:
        fail(f"{tag}: tokens {tokens.shape} out of shape or range")
    if counts["quant_matmul"] == 0 or counts["paged_attention"] or counts["flash_attention"]:
        fail(f"{tag}: launches {counts} (the dequantizing matmul only)")
    log(f"{tag}: {res['tokens_per_s']:.1f} tok/s ({res['seconds']:.3f} s, host "
        f"clock); launches {counts}")
    cfg = SchedulerConfig(max_slots=8, page_size=16, max_seq=128 + 33 + 16,
                          kv_budget_bytes=64e6, cache_dtype="fp32")
    paged, _, _, _, _, _ = _drive(
        torch, ops, spec, params, cfg,
        [Request(i, p.copy(), 33) for i, p in enumerate(prompts)],
        "static phase: paged engine, fp32 pages")
    compare_streams(list(tokens), paged,
                    f"{tag}: static engine vs paged engine (fp32 pages)")
    del params
    torch.cuda.empty_cache()
    return counts


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
        "kernels", "quantize", "decode", "serve", "ring", "gemma3", "static"}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import ops
    name, smi = phase_device(torch)
    timer = Timer(torch)
    launches = {"paged_attention": 0, "paged_window": 0, "quant_matmul": 0,
                "flash_attention": 0, "quantize_rowwise": 0}

    def add(counts):
        for k in launches:
            launches[k] += counts.get(k, 0)

    cases = {}
    if "kernels" in phases:
        cases["paged_attention"] = phase_kernels_paged(torch, timer, ops, F, TINY)[
            ("int8", "full")]
        cases["quant_matmul"] = phase_kernels_matmul(torch, timer, ops, TINY["model"])[
            (4, 8, 2048, 11264)]
        cases["paged_window"] = phase_kernels_paged(torch, timer, ops, F, TINY, K=WQ)[
            ("int8", "full")]
        cases["flash_attention"] = phase_kernels_flash(torch, timer, ops, F, TINY)[
            (256, 256, 0)]
        # the same kernels at Gemma3-1B's head and matmul shapes, and the
        # attention kernels at Llama3.2-1B's and DeepSeek-R1-1.5B's heads
        phase_kernels_paged(torch, timer, ops, F, GEMMA)
        phase_kernels_paged(torch, timer, ops, F, GEMMA, K=WQ)
        phase_kernels_flash(torch, timer, ops, F, GEMMA)
        phase_kernels_matmul(torch, timer, ops, GEMMA["model"])
        for shp in (LLAMA, DEEPSEEK):
            phase_kernels_paged(torch, timer, ops, F, shp)
            phase_kernels_paged(torch, timer, ops, F, shp, K=WQ)
            phase_kernels_flash(torch, timer, ops, F, shp)
    if "quantize" in phases:
        phase_quantizers(torch)
        quant, n = phase_kernels_quantize(torch, timer, ops)
        cases["quantize_rowwise"] = quant[(8, 8, 2048)]
        launches["quantize_rowwise"] += n
    if "decode" in phases:
        phase_decode_parity(torch, "int4", "int8")
        phase_decode_parity(torch, "fp32", "int4")
        phase_window_parity(torch, "int4", "int8")
        phase_window_parity(torch, "fp32", "int4")
        phase_step_profile(torch, "int4", "int8")
    if "serve" in phases:
        streams = {}
        for precision, cache_dtype, spec_k in (("int4", "int8", 1),
                                               ("fp32", "int4", 1),
                                               ("int4", "int8", WQ)):
            counts, _, streams[spec_k, precision] = phase_serve(
                torch, ops, precision, cache_dtype, spec_k)
            add(counts)
        compare_streams(streams[WQ, "int4"], streams[1, "int4"],
                        f"serve [int4 weights, int8 pages]: spec_k={WQ} vs spec_k=1")
        for phase in (phase_serve_spec_repeating, phase_serve_flash):
            add(phase(torch, ops, "int4", "int8"))
    if "ring" in phases:
        add(phase_ring(torch, ops))
    if "gemma3" in phases:
        add(phase_gemma3(torch, ops))
    if "static" in phases:
        add(phase_static(torch, ops))
    sources = {
        "paged_attention": ("paged_attention.cu", "paged_attention.py:122"),
        "quant_matmul": ("quant_matmul.cu", "quant_matmul.py:45"),
        "paged_window": ("paged_attention.cu", "paged_attention.py:172"),
        "flash_attention": ("flash_attention.cu", "flash_attention.py:24"),
        "quantize_rowwise": ("quantize_rowwise.cu", "quantize_kernel.py:18"),
    }
    kernels = [
        {"name": k, "route": "cuda",
         "source": f"src/repro_torch/kernels/csrc/{src}",
         "replaces": f"src/repro/kernels/{tpu}",
         "launches": launches[k], "max_abs_err": c["err"], "ms": c["ms"],
         "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
         "bound_by": c["bound_by"], "library_ms": c["library_ms"]}
        for k, (src, tpu) in sources.items() if (c := cases.get(k)) is not None]
    if not argv and not all(launches.values()):
        fail(f"a kernel of the serve paths never launched: {launches}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"[smoke] card: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
