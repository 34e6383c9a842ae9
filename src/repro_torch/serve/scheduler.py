"""Continuous-batching serve scheduler: lazy paged allocation, refcounted
prefix caching, host-tier KV swapping, and recompute-preemption.

This is the JAX package's host scheduler (``repro.serve.scheduler``)
unchanged but for its imports: it drives the port's
``serve.backend.SingleDeviceBackend``.  The notes below on compiles and
tensor-parallel backends describe the JAX package.

The static ``engine.generate`` path pads every request in a batch to the
longest prompt, decodes until the LAST request finishes, and cannot
admit work mid-flight — on the memory-bound edge decode roofline
(paper §III) all of that padding is wasted HBM traffic.  This scheduler
runs the vLLM-style alternative on top of the paged KV cache:

* requests queue host-side; admission allocates pages for the PROMPT
  only (lazy allocation — decode pages are grabbed on demand, so the
  pool runs at high occupancy instead of reserving prompt+max_new up
  front);
* prompts are first matched against the refcounted prefix store
  (``paged_cache.PrefixCache``): cached full pages are shared read-only
  across requests, a cached chunk ending mid-page is copy-on-write'd,
  and only the uncached SUFFIX is prefilled (``lm.prefill_paged``
  attends suffix queries over the gathered prefix KV) — templated /
  multi-tenant prompts skip most of their prefill FLOPs and KV writes;
* suffix prefill is bucket-padded to a power of two so XLA compiles
  O(log max_seq) prefill shapes; ``true_len`` masking keeps logits
  exact;
* with ``prefill_chunk_tokens`` set, admission is CHUNKED and
  cost-aware: each iteration may spend at most that many (bucket-
  padded) prefill tokens — the t2t ``bucket_boundaries`` idiom of
  charging admission by padded token COST, not request count — so a
  long prompt prefills as a sequence of fixed-budget chunks
  co-scheduled with everyone else's decode instead of monopolizing an
  iteration.  A chunk is just a suffix prefill whose prefix is the
  chunks already written (plus any prefix-cache hit), so the partially
  prefilled slot carries across iterations with no new kernel; only
  the FINAL chunk's logits seed decoding, and chunking changes
  scheduling only — per-request outputs stay token-for-token the
  unchunked engine's (the ``--open-loop`` benchmark gate);
* every iteration decodes one verify WINDOW — a single token unless
  speculating (``spec_k``) — for ALL live fully-prefilled slots in a
  single fixed-shape jitted step; when a slot crosses a page boundary
  it allocates its next page just-in-time — if the pool is dry the
  scheduler escalates through THREE tiers: (1) EVICT unshared
  prefix-store pages (LRU) and park idle session slots, (2) SWAP the
  newest-admitted victim to the host pool (``SchedulerConfig.
  host_pool_bytes`` — its pages gather to host DRAM over the h2d link,
  shared prefix pages are COPIED so other holders keep them, and the
  victim re-queues exactly like a preemption except its re-admission
  scatters the parked pages back and prefills only the one unwritten
  token), (3) PREEMPT recompute-style when no host pool is configured
  or it is full: non-shared pages are freed, prefix-store pages
  survive by refcount, and the victim re-queues with
  prompt+generated-so-far as its new prompt (greedy recompute resumes
  the sequence exactly, and its re-run prefill hits the cached
  prefix).  Either resume path is token-identical — swap trades
  h2d bytes for prefill FLOPs, the crossover
  ``core.latency.swap_vs_recompute`` prices;
* requests carrying a ``session`` id are MULTI-TURN: a finished turn's
  slot goes IDLE (KV held on device) instead of freeing, and the next
  turn — whose prompt must extend the prior context token-for-token —
  rejoins IN PLACE with a suffix prefill over just the tokens it
  appends.  Idle slots are invisible to ``num_active``/
  ``pending_cost``, are never preemption victims, and PARK to the host
  pool under allocation pressure or after ``idle_park_iterations``
  without a follow-up turn; a parked session's next turn swaps its
  pages back in.  ``end_session`` releases either form.  With no host
  pool the idle slot is simply dropped and the next turn re-prefills
  (prefix-cache assisted) — sessions degrade to today's behaviour;
* finished slots free their page references immediately and the next
  queued request takes the slot on the same iteration;
* with ``spec_k > 1`` every iteration runs SELF-SPECULATIVE decoding:
  each live slot drafts up to ``spec_k - 1`` tokens from its own
  context (n-gram prompt lookup, ``serve.spec_decode.NGramDraftTable``
  — no second model), the whole window is verified in ONE multi-query
  paged decode step (``models.lm.decode_window_paged``), and greedy
  acceptance commits the matching prefix plus one bonus token.  Slots
  whose lookup misses simply run a 1-token window inside the same
  fixed-shape step, and the slot's position only advances over ACCEPTED
  tokens, so rejected-draft KV never enters the valid context.  Decode
  is memory-bound on every edge roofline the paper profiles (weights +
  pages re-read per step), so each accepted token amortizes that
  traffic — emissions stay token-for-token identical to ``spec_k=1``
  greedy decode (asserted in tests/test_spec_decode.py and the
  ``benchmarks/serve_throughput.py --spec-decode`` gate).

* the request LIFECYCLE is typed and fault-aware: ``Request`` carries
  an optional ``deadline_s`` (queued work past its deadline is SHED
  with a typed ``Completion(status="shed")`` instead of admitted late)
  and a NaN retry budget; every decode step returns a per-slot
  finite-logits flag and a flagged slot FAILS — requeue-recompute
  while retries remain, ``status="failed"`` after — rather than
  committing garbage tokens; ``export_active`` detaches live slots as
  migration records so a dying replica's admitted work moves to
  survivors with zero requests lost (``serve/faults.py`` injects the
  faults, ``serve/router.py`` health checks drive the failover).

Greedy decoding matches per-request static ``generate`` token-for-token
with prefix caching on or off (asserted in tests/test_prefix_cache.py),
and the allocator invariants hold under random interleavings
(hypothesis fuzz ibid.).

The scheduler is the HOST half of a host/device split: every device
interaction — fused admission prefills, the batched decode step, CoW
page copies, slot release, block-table writes — goes through a
``serve.backend.PagedKVBackend``.  The default ``SingleDeviceBackend``
reproduces the one-device behaviour; ``ShardedPagedBackend`` runs the
same host logic over a KV-head-sharded, tensor-parallel page pool with
token-for-token identical output (tests/test_serve_backend_multidevice).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.model_config import ModelSpec
from repro_torch.serve import paged_cache as pc
from repro_torch.serve.backend import PagedKVBackend, SingleDeviceBackend
from repro_torch.serve.spec_decode import NGramDraftTable


@dataclass
class Request:
    uid: int
    prompt: np.ndarray             # (S,) int32 token ids
    max_new_tokens: int
    # deadline in seconds since arrival: a request still QUEUED when it
    # expires is SHED (typed completion, never admitted) — starting
    # work that is already late just delays everyone else.  None = no
    # deadline.  Admitted slots always run to completion.
    deadline_s: Optional[float] = None
    # NaN-guard retry budget: how many times a corrupted-logits failure
    # may requeue (recompute-style) before the request fails for good
    retries: int = 0
    # stamped by the first submit(); carried across preemption, retry
    # and cross-replica migration so deadlines measure true age
    arrival_t: Optional[float] = None
    # multi-turn chat: requests sharing a session id extend one
    # conversation.  A finished turn's slot goes IDLE instead of
    # freeing (KV kept on device, parked to the host pool under
    # pressure or after the idle threshold), and the next turn — whose
    # prompt must extend the prior context — rejoins with a one-token
    # suffix prefill instead of re-prefilling the whole history.
    session: Optional[int] = None


@dataclass
class Completion:
    uid: int
    prompt_len: int
    tokens: np.ndarray             # generated ids (short of the budget
                                   # when status != "ok")
    # "ok"     — ran to its token budget
    # "shed"   — dropped by deadline or SLO backpressure before/without
    #            admission (tokens = any prior preempted output)
    # "failed" — NaN/inf logits with the retry budget exhausted
    # Typed loss is the fault-tolerance contract: every submitted uid
    # gets exactly one Completion, whatever happens to its replica.
    status: str = "ok"


@dataclass
class SchedulerConfig:
    max_slots: int = 8
    page_size: int = 16
    max_seq: int = 1024            # per-slot context ceiling
    num_pages: Optional[int] = None
    kv_budget_bytes: Optional[float] = None
    cache_dtype: str = "fp32"      # fp32 | int8 | int4 (nibble-packed pages)
    # prefill attention impl for COLD admissions; prefix-hit (suffix)
    # prefills always use the dense-masked path in lm._suffix_attn_paged
    # — the suffix x [gathered prefix; suffix] mask has no flash lowering
    attention_impl: str = "naive"
    enable_prefix_cache: bool = True
    # self-speculative decoding: verify windows of up to spec_k tokens
    # per slot per iteration (1 = off, the plain one-token decode step);
    # drafts come from an n-gram prompt-lookup table over each request's
    # own context (no draft model), matching on spec_ngram-grams
    spec_k: int = 1
    spec_ngram: int = 2
    # chunked prefill: per-ITERATION prefill-token budget (0 = off, the
    # legacy admit-the-whole-prompt path).  Charged in bucket-padded
    # (power-of-two-page) widths — admission is cost-aware in TOKENS,
    # not request count — and a prompt wider than the budget carries a
    # partially-prefilled slot across iterations (each chunk is a
    # suffix prefill over the chunks already written).  Must be a
    # positive multiple of page_size when set.
    prefill_chunk_tokens: int = 0
    # host memory tier: bytes of host DRAM the engine may park KV in
    # (swap-out instead of recompute for preemption victims and idle
    # sessions).  None/0 disables swapping — preemption recomputes and
    # idle sessions hold device pages until dropped under pressure.
    # Size it from HardwareSpec.host_mem_capacity minus weights/OS.
    host_pool_bytes: Optional[float] = None
    # park an idle session slot's KV to the host pool once it has sat
    # idle this many scheduler iterations (0 = never on the timer;
    # pressure from _reserve still parks/drops idle slots on demand)
    idle_park_iterations: int = 8
    # windowed (ring) KV for uniformly sliding-window stacks: None
    # auto-detects (ring when every KV layer is attn_local with a
    # window — gemma-style local stacks), False forces the mask-only
    # reference (windowed attention math, full-attention memory: the
    # token-identity baseline the --window gate compares against), True
    # asserts the stack qualifies.  With the ring each slot's KV is
    # bounded at O(window) pages forever — out-of-window pages are
    # recycled in place when exclusively owned and their reference
    # dropped (never stolen) when the prefix store or another slot
    # still shares them — so the same pool bytes admit proportionally
    # more concurrent unbounded streams.
    windowed_kv: Optional[bool] = None
    # audit mode: run allocator + host-pool + slot/page invariant
    # checks after every step() so a refcount bug surfaces at the
    # iteration that caused it (tier-1 test fixtures enable this)
    debug_invariants: bool = False


@dataclass
class _Slot:
    uid: int
    prompt: np.ndarray             # prompt THIS incarnation prefilled
    prompt_len: int
    max_new: int                   # remaining budget this incarnation
    pages: List[int]
    last_token: int
    admit_seq: int                 # recency order for victim selection
    generated: List[int] = field(default_factory=list)
    draft: Optional[NGramDraftTable] = None   # spec_k > 1: prompt lookup
    # prompt tokens whose KV is already written (prefix-cache hits plus
    # completed chunks); < prompt_len means the slot is mid-prefill and
    # sits out decode windows until its final chunk lands
    prefilled: int = 0
    # request-lifecycle state carried from the Request (preserved across
    # preemption, NaN-retry requeues and cross-replica migration)
    deadline_s: Optional[float] = None
    retries_left: int = 0
    arrival_t: Optional[float] = None
    # multi-turn session keep-alive: a finished turn with a session id
    # parks the slot IDLE (pages + device KV held, no decode work)
    # instead of freeing, so the next turn rejoins without re-prefill
    session: Optional[int] = None
    idle: bool = False
    idle_since: float = 0.0            # stats["iterations"] stamp
    # ring KV bookkeeping: ABSOLUTE pages this slot's context has ever
    # covered.  On flat engines it always equals len(pages); on ring
    # engines it keeps counting past the ring capacity R while
    # len(pages) stays pinned at R — the write head's next ring entry
    # is abs_pages % R, and abs_pages > len(pages) means the slot has
    # wrapped (its entries hold the LAST R absolute pages, the
    # out-of-window remainder recycled)
    abs_pages: int = 0

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new

    @property
    def prefilling(self) -> bool:
        return self.prefilled < self.prompt_len


@dataclass
class _Resume:
    """Host bookkeeping for a preempted request: tokens generated before
    eviction (spliced back into its Completion) and the original prompt
    length (the resumed incarnation's prompt includes prior output)."""
    orig_prompt_len: int
    prior: List[int]


def _bucket(n: int, page_size: int, max_seq: int) -> int:
    """Pad a prompt length to the next power-of-two page count.

    The cap is ``max_seq`` rounded UP to a page multiple: the bucket is
    a page-granular COMPUTE width (admission scatters whole pages), not
    a context bound, so when ``page_size`` does not divide ``max_seq``
    the padded width may exceed ``max_seq`` — context limits are
    enforced at ``submit`` against true lengths.  (Capping at a raw
    ``max_seq`` used to truncate the scatter page count and drop the
    tail of prompts whose true pages fit — the ``_bucket``/``max_seq``
    boundary tests pin this.)
    """
    pages = pc.pages_needed(n, page_size)
    b = 1
    while b < pages:
        b *= 2
    cap = pc.pages_needed(max_seq, page_size) * page_size
    return min(b * page_size, cap)


def _pow2_pages(n: int, cap: int) -> int:
    """Static gather width for cached-prefix pages (compile bucketing)."""
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


class ContinuousBatchingEngine:
    """Iteration-level scheduler over a refcounted paged KV cache.

    ``step()`` = admit-from-queue (full or suffix prefill) + lazy decode
    page growth (with prefix-store eviction and preemption under
    pressure) + one batched decode.  All device state lives behind the
    ``backend`` (a ``serve.backend.PagedKVBackend``); the engine itself
    is pure host bookkeeping, so the same scheduler drives one device
    or a tensor-parallel sharded pool unchanged.  Counters (``stats``)
    feed the throughput benchmark and the analytical model's
    occupancy / prefix-hit inputs.
    """

    def __init__(self, params: Any, spec: ModelSpec, cfg: SchedulerConfig,
                 backend: Optional[PagedKVBackend] = None):
        # params is consumed only to build the default backend — the
        # engine itself never touches device state (an explicit backend
        # already owns its own params)
        self.spec, self.cfg = spec, cfg
        if cfg.prefill_chunk_tokens:
            if (cfg.prefill_chunk_tokens < cfg.page_size
                    or cfg.prefill_chunk_tokens % cfg.page_size):
                raise ValueError(
                    f"prefill_chunk_tokens={cfg.prefill_chunk_tokens} must "
                    f"be a positive multiple of page_size={cfg.page_size} "
                    "(the budget is charged in page-granular bucket widths)")
        self.backend = backend if backend is not None else \
            SingleDeviceBackend(params, spec, cfg)
        self.layout = self.backend.layout
        self.plan = self.backend.plan
        # ring KV: the backend resolved cfg.windowed_kv against the
        # stack (window > 0 only when every KV layer is attn_local) and
        # sized pages_per_slot to the O(window) ring capacity R — every
        # slot's KV is bounded at R pages no matter how long it streams
        self.window = int(getattr(self.backend, "window", 0) or 0)
        self.ring = bool(getattr(self.backend, "ring", False))
        self.alloc = pc.PageAllocator(self.layout.num_pages)
        self.prefix_cache: Optional[pc.PrefixCache] = (
            pc.PrefixCache(self.alloc, cfg.page_size)
            if cfg.enable_prefix_cache else None)
        self.slots: List[Optional[_Slot]] = [None] * cfg.max_slots
        self.queue: Deque[Request] = deque()
        self._resume: Dict[int, _Resume] = {}
        self._admit_seq = 0
        # host memory tier: parked KV of swapped-out victims (keyed
        # ("uid", uid)) and idle sessions (keyed ("sess", session))
        self.host_pool: Optional[pc.HostPagePool] = (
            pc.HostPagePool(cfg.host_pool_bytes)
            if cfg.host_pool_bytes else None)
        self._host_page_bytes = (self.backend.host_page_bytes()
                                 if self.host_pool is not None else 0)
        self.stats: Dict[str, float] = {
            "iterations": 0, "decode_tokens": 0, "prefill_tokens": 0,
            "prompt_tokens": 0, "prefix_hit_tokens": 0, "admitted": 0,
            "finished": 0, "preemptions": 0, "cow_copies": 0,
            "prefix_evicted_pages": 0, "occupancy_sum": 0.0,
            # speculative decode: windows with >= 1 drafted token,
            # drafted-token count, and how many of them were accepted
            # (measured acceptance = spec_accepted / spec_drafted)
            "spec_steps": 0, "spec_drafted": 0, "spec_accepted": 0,
            # recompute re-prefills (preemption resumes) count here, NOT
            # in prompt_tokens/prefix_hit_tokens: a resumed prompt
            # includes prior OUTPUT and mostly re-hits its own pages, so
            # folding it in would inflate the prefix-hit-rate fed to
            # core/analytical.py
            "recompute_prompt_tokens": 0, "recompute_hit_tokens": 0,
            # chunked prefill: chunks issued for already-admitted slots
            # (first chunks count under "admitted")
            "prefill_chunks": 0,
            # request-lifecycle robustness: deadline sheds, NaN-guard
            # slot failures, the retries they spent, and requests that
            # failed for good (budget exhausted)
            "shed": 0, "nan_failures": 0, "retries": 0, "failed": 0,
            # host-tier swapping: pressure swap-outs of live victims,
            # swap-in resumes, pages moved each way, idle sessions
            # parked/dropped, and live in-place session reattaches.
            # session_prompt/hit tokens count session rejoins separately
            # from prefix_hit_tokens (the hit never touched the store)
            # and recompute_* (nothing was recomputed)
            "swap_outs": 0, "swap_ins": 0, "swapped_out_pages": 0,
            "swapped_in_pages": 0, "idle_parks": 0, "idle_drops": 0,
            "session_reuses": 0, "session_prompt_tokens": 0,
            "session_hit_tokens": 0,
            # ring KV: exclusively-owned pages recycled in place as
            # they fell out of the window (each one is an allocation —
            # and a potential preemption — the flat engine would have
            # paid), and shared pages whose reference this slot
            # released for a fresh one (prefix store / other holders
            # kept the bytes; nothing was stolen)
            "ring_recycled_pages": 0, "ring_shared_released": 0}
        # injectable wall clock for deadline shedding (tests freeze it)
        self.clock = time.monotonic

    # -- queue ------------------------------------------------------------

    def submit(self, req: Request) -> None:
        total = len(req.prompt) + req.max_new_tokens
        if total > self.cfg.max_seq:
            raise ValueError(f"request {req.uid}: context {total} exceeds "
                             f"max_seq {self.cfg.max_seq}")
        n_pages = pc.pages_needed(total, self.cfg.page_size)
        if self.ring:
            # ring KV: a slot never holds more than the ring capacity,
            # however long the stream — O(window) admission sizing is
            # exactly what multiplies concurrency at fixed pool bytes
            n_pages = min(n_pages, self.layout.slots_pages(self.cfg.max_seq))
        if n_pages > self.layout.num_pages - 1:
            # would never admit even running SOLO with the whole store
            # evicted: run() would spin on the FCFS head forever
            raise ValueError(
                f"request {req.uid}: needs {n_pages} pages but the pool "
                f"only has {self.layout.num_pages - 1} usable")
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if req.arrival_t is None:
            req.arrival_t = self.clock()
        self.queue.append(req)

    @property
    def num_active(self) -> int:
        """Slots doing WORK (prefilling or decoding).  Idle session
        slots are excluded: they hold device pages but consume no
        iteration compute and are reclaimable on demand (park/drop), so
        they are neither admission headroom nor router occupancy."""
        return sum(s is not None and not s.idle for s in self.slots)

    @property
    def num_idle(self) -> int:
        return sum(s is not None and s.idle for s in self.slots)

    @property
    def num_parked(self) -> int:
        return len(self.host_pool) if self.host_pool is not None else 0

    def _queued_context(self, req: Request) -> int:
        """KV rows a queued request already holds in some tier — a
        parked swap record, or a live idle slot of its session — i.e.
        rows its admission will NOT re-prefill.  Token validation is
        deferred to admission; this is the load-accounting estimate."""
        if self.host_pool is not None:
            rec = self.host_pool.peek(("uid", req.uid))
            if rec is None and req.session is not None:
                rec = self.host_pool.peek(("sess", req.session))
            if rec is not None and len(req.prompt) > rec.written:
                return rec.written
        if req.session is not None:
            i = self._find_idle(req.session)
            if i is not None:
                s = self.slots[i]
                ctx = s.prompt_len + len(s.generated)
                if len(req.prompt) >= ctx:
                    return ctx - 1
        return 0

    @property
    def pending_cost(self) -> int:
        """Bucket-padded token cost of work not yet decoded: queued
        prompts + their decode budgets, unfinished prefill remainders,
        and live slots' remaining decode tokens.  The router's load
        signal — COST, not request count — so one 2k-token prompt
        weighs as much as the sixteen short requests it displaces.
        Work whose KV is PARKED (host pool) or held by an idle session
        slot charges only its rejoin suffix, not the full context — a
        swapped-out victim costs a page scatter plus one bucket, and
        counting its whole prompt as device work would make the router
        spill traffic away from exactly the replica that can resume it
        cheaply.  Idle slots themselves contribute nothing: their pages
        are host-reclaimable capacity, not pending device work."""
        page, cap = self.cfg.page_size, self.cfg.max_seq
        cost = 0
        for r in self.queue:
            suffix = len(r.prompt) - self._queued_context(r)
            cost += _bucket(suffix, page, cap) + r.max_new_tokens
        for s in self.slots:
            if s is None or s.idle:
                continue
            if s.prefilling:
                cost += _bucket(s.prompt_len - s.prefilled, page, cap)
            cost += s.max_new - len(s.generated)
        return cost

    def progress(self) -> Dict[int, int]:
        """Tokens emitted so far per LIVE request uid (a preempted
        incarnation's prior output included, so counts are monotone
        across recompute).  Open-loop drivers poll this after each
        ``step()`` to timestamp first-token / inter-token latencies
        without reaching into slots."""
        out: Dict[int, int] = {}
        for s in self.slots:
            if s is None:
                continue
            res = self._resume.get(s.uid)
            prior = len(res.prior) if res is not None else 0
            out[s.uid] = prior + len(s.generated)
        return out

    @property
    def head_is_resume(self) -> bool:
        """True when the queue head is a preemption/retry RECOMPUTE
        resume.  The router's rebalance donor scan skips these: a
        resume re-prefill mostly re-hits its own replica's pages, and
        head-of-line recompute priority is the preemption contract —
        stealing it would cold-prefill prior output elsewhere."""
        return bool(self.queue) and self.queue[0].uid in self._resume

    def take_queued(self) -> List[Request]:
        """Hand back every QUEUED (not yet admitted) request, emptying
        the queue — the router's drain path on replica removal.  A
        drained swap resume recomputes on its new replica (its resume
        record follows via ``export_resume``); the parked bytes it
        left here are dead, so drop them."""
        out = list(self.queue)
        self.queue.clear()
        if self.host_pool is not None:
            for r in out:
                self.host_pool.drop(("uid", r.uid))
        return out

    def export_resume(self, uid: int) -> Optional[_Resume]:
        """Detach a preempted request's resume record (prior output +
        original prompt length) so it can follow the request to another
        replica; None if ``uid`` was never preempted."""
        return self._resume.pop(uid, None)

    def adopt_resume(self, uid: int, record: _Resume) -> None:
        """Install a resume record exported from another engine: the
        re-routed recompute request's completion splices its prior
        output exactly as if it had resumed here."""
        self._resume[uid] = record

    def export_active(self
                      ) -> Tuple[List[Tuple[Request, _Resume]],
                                 List[Completion]]:
        """Detach every ADMITTED slot as a (Request, resume-record)
        migration pair — the router's FAILOVER path when a replica dies
        with live slots.  Tokens committed so far become the resume
        record's prior output; the request carries prompt+generated as
        its new prompt, so the adopting replica's greedy recompute
        resumes the stream exactly (the preemption contract, applied
        across replicas).  Slots that already hit their budget complete
        instead (second return).  HOST state only: the backend may be
        dead, so nothing here touches the device — pages are returned
        to the (doomed) host allocator purely to keep its invariants
        checkable."""
        records: List[Tuple[Request, _Resume]] = []
        completions: List[Completion] = []
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            if slot.idle:
                # idle sessions have already completed their turn; the
                # held KV cannot follow a host-state-only migration, so
                # the next turn simply cold-prefills on the survivor
                self.alloc.free(slot.pages)
                self.slots[i] = None
                continue
            res = self._resume.pop(slot.uid, None)
            prior = res.prior if res is not None else []
            orig = res.orig_prompt_len if res is not None else slot.prompt_len
            self.alloc.free(slot.pages)
            self.slots[i] = None
            if slot.done:
                toks = prior + slot.generated[:slot.max_new]
                completions.append(Completion(
                    slot.uid, orig, np.asarray(toks, np.int32)))
                self.stats["finished"] += 1
                continue
            remaining = slot.max_new - len(slot.generated)
            req = Request(
                slot.uid,
                np.concatenate([slot.prompt,
                                np.asarray(slot.generated, np.int32)]),
                remaining, deadline_s=slot.deadline_s,
                retries=slot.retries_left, arrival_t=slot.arrival_t,
                session=slot.session)
            records.append((req, _Resume(orig, prior + slot.generated)))
        return records, completions

    # -- page pressure ----------------------------------------------------

    def _reserve(self, n: int) -> bool:
        """Make ``n`` pages allocatable: evict unshared prefix-store
        pages (LRU), then reclaim IDLE session slots — parking their KV
        to the host pool when it has room, dropping the session when it
        doesn't.  Either way costs a transfer or a future re-prefill of
        someone who isn't running, never a recompute of live work —
        preemption stays the decode-growth path's escalation."""
        if self.alloc.can_alloc(n):
            return True
        if self.prefix_cache is not None:
            self.stats["prefix_evicted_pages"] += self.prefix_cache.evict(
                n - self.alloc.free_pages)
        if not self.alloc.can_alloc(n):
            for i in self._idle_slots_lru():
                self._park_idle(i)
                if self.alloc.can_alloc(n):
                    break
        return self.alloc.can_alloc(n)

    def _pick_victim(self) -> Optional[int]:
        """Newest-admitted live slot (FCFS: the head of the line is the
        last to be preempted).  Idle session slots are never victims —
        ``_reserve`` already reclaimed them, and they have no work to
        requeue."""
        best, best_seq = None, -1
        for i, slot in enumerate(self.slots):
            if (slot is not None and not slot.idle
                    and slot.admit_seq > best_seq):
                best, best_seq = i, slot.admit_seq
        return best

    def _idle_slots_lru(self) -> List[int]:
        """Idle session slots, longest-idle first (the reclaim order)."""
        return sorted((i for i, s in enumerate(self.slots)
                       if s is not None and s.idle),
                      key=lambda i: self.slots[i].idle_since)

    def _find_idle(self, session: int) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is not None and s.idle and s.session == session:
                return i
        return None

    def _park_idle(self, idx: int) -> None:
        """Reclaim an idle session slot's device pages: park its KV in
        the host pool when there is room (the next turn rejoins with a
        page scatter + one-token prefill), else drop the session (the
        next turn re-prefills cold).  Shared prefix pages are COPIED
        into the blob and only this slot's references freed, so other
        holders keep their device pages."""
        slot = self.slots[idx]
        assert slot is not None and slot.idle
        key = ("sess", slot.session)
        can = (self.host_pool is not None and key not in self.host_pool
               and self.host_pool.can_park(
                   len(slot.pages) * self._host_page_bytes))
        if can:
            blob = self.backend.swap_out(slot.pages)  # device call first
            self.backend.release_slot(idx)
            context = np.concatenate(
                [slot.prompt, np.asarray(slot.generated, np.int32)])
            self.host_pool.park(key, pc.ParkedKV(
                context=context, written=len(context) - 1,
                n_pages=len(slot.pages), blob=blob,
                nbytes=pc.blob_nbytes(blob), abs_pages=slot.abs_pages))
            self.stats["idle_parks"] += 1
            self.stats["swapped_out_pages"] += len(slot.pages)
        else:
            self.backend.release_slot(idx)
            self.stats["idle_drops"] += 1
        self.alloc.free(slot.pages)
        self.slots[idx] = None

    def _swap_out(self, idx: int) -> bool:
        """Swap tier of the evict→swap→preempt escalation: park a live
        victim's KV in the host pool instead of discarding it.  Host
        bookkeeping is EXACTLY ``_preempt`` (resume record with prior
        output spliced, prompt+generated requeued at the head) — the
        parked blob is a pure accelerator the swap-in admission finds
        by uid, so if the request migrates or sheds first, the normal
        recompute path still resumes it.  Returns False (caller falls
        back to ``_preempt``) when the pool is absent/full or the
        victim is mid-prefill (its KV is not yet worth the transfer)."""
        slot = self.slots[idx]
        assert slot is not None and not slot.done
        if self.host_pool is None or slot.prefilling:
            return False
        key = ("uid", slot.uid)
        if (key in self.host_pool
                or not self.host_pool.can_park(
                    len(slot.pages) * self._host_page_bytes)):
            return False
        blob = self.backend.swap_out(slot.pages)  # device first (see _preempt)
        self.backend.release_slot(idx)
        res = self._resume.get(slot.uid)
        prior = (res.prior if res else []) + slot.generated
        orig_plen = res.orig_prompt_len if res else slot.prompt_len
        self._resume[slot.uid] = _Resume(orig_plen, prior)
        remaining = slot.max_new - len(slot.generated)
        new_prompt = np.concatenate(
            [slot.prompt, np.asarray(slot.generated, np.int32)])
        self.host_pool.park(key, pc.ParkedKV(
            context=new_prompt, written=len(new_prompt) - 1,
            n_pages=len(slot.pages), blob=blob,
            nbytes=pc.blob_nbytes(blob), abs_pages=slot.abs_pages))
        self.alloc.free(slot.pages)
        self.slots[idx] = None
        self.queue.appendleft(Request(
            slot.uid, new_prompt, remaining, deadline_s=slot.deadline_s,
            retries=slot.retries_left, arrival_t=slot.arrival_t,
            session=slot.session))
        self.stats["swap_outs"] += 1
        self.stats["swapped_out_pages"] += len(slot.pages)
        return True

    def _preempt(self, idx: int) -> None:
        """Evict a slot: free its page references (prefix-store pages
        survive by refcount), splice its output so far into the resume
        record, and re-queue prompt+generated as a recompute request at
        the queue head."""
        slot = self.slots[idx]
        assert slot is not None and not slot.done
        # device call FIRST: a dying backend raises before any host
        # state mutates, so the failover export sees a consistent slot
        # (no half-freed pages, no doubled resume splice)
        self.backend.release_slot(idx)
        res = self._resume.get(slot.uid)
        prior = (res.prior if res else []) + slot.generated
        orig_plen = res.orig_prompt_len if res else slot.prompt_len
        self._resume[slot.uid] = _Resume(orig_plen, prior)
        remaining = slot.max_new - len(slot.generated)
        new_prompt = np.concatenate(
            [slot.prompt, np.asarray(slot.generated, np.int32)])
        self.alloc.free(slot.pages)
        self.slots[idx] = None
        self.queue.appendleft(Request(
            slot.uid, new_prompt, remaining, deadline_s=slot.deadline_s,
            retries=slot.retries_left, arrival_t=slot.arrival_t,
            session=slot.session))
        self.stats["preemptions"] += 1

    def _fail_slot(self, idx: int, completions: List[Completion]) -> None:
        """NaN guard: the decode step flagged this slot's logits as
        non-finite, so nothing it sampled may commit.  With retry
        budget left the request requeues recompute-style (prompt +
        committed-so-far, prior output spliced on completion) — a
        transient corruption replays cleanly because only tokens from
        FINITE steps were ever committed.  Budget exhausted, it
        completes as ``status="failed"`` with the tokens it honestly
        produced: typed failure, never silent garbage."""
        slot = self.slots[idx]
        assert slot is not None
        self.backend.release_slot(idx)    # device first (see _preempt)
        res = self._resume.pop(slot.uid, None)
        prior = (res.prior if res is not None else []) + slot.generated
        orig = res.orig_prompt_len if res is not None else slot.prompt_len
        self.alloc.free(slot.pages)
        self.slots[idx] = None
        self.stats["nan_failures"] += 1
        if slot.retries_left > 0:
            self._resume[slot.uid] = _Resume(orig, prior)
            self.queue.appendleft(Request(
                slot.uid,
                np.concatenate([slot.prompt,
                                np.asarray(slot.generated, np.int32)]),
                slot.max_new - len(slot.generated),
                deadline_s=slot.deadline_s, retries=slot.retries_left - 1,
                arrival_t=slot.arrival_t, session=slot.session))
            self.stats["retries"] += 1
        else:
            completions.append(Completion(
                slot.uid, orig, np.asarray(prior, np.int32),
                status="failed"))
            self.stats["failed"] += 1

    def _shed_expired(self, completions: List[Completion]) -> None:
        """Deadline shedding: drop QUEUED requests whose deadline has
        passed (admitted slots always run — aborting mid-decode wastes
        the KV already paid for).  Shed completions carry any prior
        preempted output and ``status="shed"``; the uid still resolves,
        so open-loop drivers count the drop instead of hanging on it."""
        if not any(r.deadline_s is not None for r in self.queue):
            return
        now = self.clock()
        kept: Deque[Request] = deque()
        for req in self.queue:
            expired = (req.deadline_s is not None
                       and req.arrival_t is not None
                       and now - req.arrival_t > req.deadline_s)
            if not expired:
                kept.append(req)
                continue
            res = self._resume.pop(req.uid, None)
            prior = res.prior if res is not None else []
            orig = res.orig_prompt_len if res is not None else len(req.prompt)
            if self.host_pool is not None:
                self.host_pool.drop(("uid", req.uid))   # parked bytes are dead
            completions.append(Completion(
                req.uid, orig, np.asarray(prior, np.int32), status="shed"))
            self.stats["shed"] += 1
        self.queue = kept

    # -- one iteration ----------------------------------------------------

    def _chunk_quota(self, budget: int) -> int:
        """Widest power-of-two-page prefill chunk whose BUCKET cost fits
        the remaining budget (length-bucketed admission: the charge is
        the padded compute width ``_bucket`` will pick, so quota must be
        a pow2 page count — a 3-page quota would bucket to 4 pages and
        overdraw)."""
        pages = budget // self.cfg.page_size
        if pages < 1:
            return 0
        b = 1
        while b * 2 <= pages:
            b *= 2
        return b * self.cfg.page_size

    def _complete_prefill(self, slot: _Slot, tok0: int) -> None:
        """The final chunk landed: seed decoding with its sampled token,
        build the spec-decode draft table, and publish the now-complete
        prompt KV to the prefix store (registering earlier would let
        other requests match pages whose rows aren't written yet)."""
        slot.last_token = tok0
        slot.generated.append(tok0)
        if self.cfg.spec_k > 1:
            draft = NGramDraftTable(self.cfg.spec_ngram)
            draft.extend(slot.prompt.tolist())
            draft.extend([tok0])
            slot.draft = draft
        # a WRAPPED ring slot's entries no longer map absolute prompt
        # pages flat (the out-of-window prefix was recycled), so only
        # prompts that still sit unwrapped publish to the prefix store
        if (self.prefix_cache is not None
                and slot.abs_pages <= len(slot.pages)):
            self.prefix_cache.register_prompt(slot.prompt, slot.pages)

    def _continue_prefills(self, budget: Optional[int]) -> Optional[int]:
        """Advance partially-prefilled slots (admission order) by one
        bucketed chunk each, consuming the iteration's prefill budget.
        Each chunk is a suffix prefill whose prefix is everything
        already written — prefix-cache hits plus earlier chunks — so
        the backend path is ``prefill_chunk`` (== ``admit_prefix``'s
        gathered-page attention) and only the final chunk's sampled
        token is kept."""
        if budget is None:
            return None
        page = self.cfg.page_size
        row_len = self.layout.slots_pages(self.cfg.max_seq)
        order = sorted(
            (i for i, s in enumerate(self.slots)
             if s is not None and s.prefilling),
            key=lambda i: self.slots[i].admit_seq)
        for i in order:
            quota = self._chunk_quota(budget)
            if quota == 0:
                break
            slot = self.slots[i]
            chunk = min(slot.prompt_len - slot.prefilled, quota)
            spad = _bucket(chunk, page, self.cfg.max_seq)
            padded = np.zeros((1, spad), np.int32)
            padded[0, :chunk] = slot.prompt[
                slot.prefilled:slot.prefilled + chunk]
            row = np.full((row_len,), pc.NULL_PAGE, np.int32)
            row[:len(slot.pages)] = slot.pages
            # ring engines gather the WHOLE ring (the entry↔absolute-
            # page mapping is mod-R over all entries); flat engines
            # bucket the written-prefix width for compile reuse
            npp = (row_len if self.ring else
                   _pow2_pages(pc.pages_needed(slot.prefilled, page),
                               row_len))
            tok0 = self.backend.prefill_chunk(
                padded, i, slot.prefilled, chunk, row, n_prefix_pages=npp)
            slot.prefilled += chunk
            budget -= spad
            self.stats["prefill_tokens"] += chunk
            self.stats["prefill_chunks"] += 1
            if not slot.prefilling:
                self._complete_prefill(slot, tok0)
        return budget

    def _first_chunk(self, i: int, budget: Optional[int],
                     matched: int) -> Optional[int]:
        """Issue the rejoin suffix prefill for a freshly reattached slot
        (live session reuse or swap-in): its first ``matched`` context
        rows are already written, so the suffix — at minimum the one
        unwritten last context token — prefills through the standard
        ``admit_prefix``/``prefill_chunk`` path, which installs the
        block-table row and pos.  One chunk lands now; any remainder
        carries via ``_continue_prefills`` like every chunked
        admission.  Returns the remaining budget."""
        slot = self.slots[i]
        page = self.cfg.page_size
        row_len = self.layout.slots_pages(self.cfg.max_seq)
        suffix_len = slot.prompt_len - matched
        chunk = (suffix_len if budget is None
                 else min(suffix_len, self._chunk_quota(budget)))
        spad = _bucket(chunk, page, self.cfg.max_seq)
        padded = np.zeros((1, spad), np.int32)
        padded[0, :chunk] = slot.prompt[matched:matched + chunk]
        row = np.full((row_len,), pc.NULL_PAGE, np.int32)
        row[:len(slot.pages)] = slot.pages
        npp = (row_len if self.ring else
               _pow2_pages(pc.pages_needed(matched, page), row_len))
        tok0 = (self.backend.admit_prefix(padded, i, matched, chunk, row,
                                          n_prefix_pages=npp)
                if chunk == suffix_len else
                self.backend.prefill_chunk(padded, i, matched, chunk, row,
                                           n_prefix_pages=npp))
        slot.prefilled = matched + chunk
        self.stats["prefill_tokens"] += chunk
        if slot.prefilling:
            self.stats["prefill_chunks"] += 1
        else:
            self._complete_prefill(slot, tok0)
        return None if budget is None else budget - spad

    def _try_resume_idle(self, budget: Optional[int]) -> Optional[int]:
        """Queue-head session reuse of a LIVE idle slot: the previous
        turn's KV never left the device, so the new turn — which must
        extend the prior context token-for-token — rejoins IN PLACE
        with a suffix prefill over just the tokens it appends (plus the
        one unwritten last token).  FCFS: only the head may jump back
        into its old slot.  A head whose prompt does not extend the
        context drops the stale session and admits cold."""
        if not self.queue:
            return budget
        req = self.queue[0]
        if req.session is None or req.uid in self._resume:
            return budget
        i = self._find_idle(req.session)
        if i is None:
            return budget
        slot = self.slots[i]
        ctx = slot.prompt_len + len(slot.generated)
        plen = len(req.prompt)
        context = np.concatenate(
            [slot.prompt, np.asarray(slot.generated, np.int32)])
        if plen < ctx or not np.array_equal(req.prompt[:ctx], context):
            self.backend.release_slot(i)
            self.alloc.free(slot.pages)
            self.slots[i] = None
            self.stats["idle_drops"] += 1
            return budget
        if budget is not None and self._chunk_quota(budget) == 0:
            return budget
        written = ctx - 1
        headroom = self.num_active
        slot.idle = False          # claim the slot: _reserve must not park it
        # cover the new turn's pages before its suffix prefill installs
        # the block-table row: appends while the ring is filling, and on
        # a full ring advances entries (CoW-releasing any the prefix
        # store still shares) so the suffix never scatters into shared
        # bytes.  Partial progress is kept on failure — the retry next
        # iteration resumes where this one stopped.
        target = max(pc.pages_needed(plen, self.cfg.page_size),
                     slot.abs_pages)
        if not self._ring_extend(slot, target, headroom=headroom):
            slot.idle = True
            return budget          # FCFS: wait for pages
        self.queue.popleft()
        slot.uid = req.uid
        slot.prompt = req.prompt
        slot.prompt_len = plen
        slot.max_new = req.max_new_tokens
        slot.generated = []
        slot.draft = None
        slot.last_token = -1
        slot.prefilled = written
        slot.admit_seq = self._admit_seq
        slot.deadline_s = req.deadline_s
        slot.retries_left = req.retries
        slot.arrival_t = req.arrival_t
        self._admit_seq += 1
        self.stats["admitted"] += 1
        self.stats["session_reuses"] += 1
        self.stats["session_prompt_tokens"] += plen
        self.stats["session_hit_tokens"] += written
        try:
            return self._first_chunk(i, budget, written)
        except Exception:
            # zero-lost: a backend dying mid-rejoin must not strand the
            # popped request — the held KV is lost but the request
            # recomputes cleanly on whoever adopts it
            self.alloc.free(slot.pages)
            self.slots[i] = None
            self.queue.appendleft(req)
            raise

    def _parked_key(self, req: Request) -> Optional[tuple]:
        """Host-pool key a queued request can resume from, if any:
        swapped-out victims by uid, parked idle sessions by session."""
        if self.host_pool is None:
            return None
        if ("uid", req.uid) in self.host_pool:
            return ("uid", req.uid)
        if (req.session is not None
                and ("sess", req.session) in self.host_pool):
            return ("sess", req.session)
        return None

    def _admit_swapped(self, i: int, req: Request, key: tuple,
                       budget: Optional[int]
                       ) -> Tuple[str, Optional[int]]:
        """Swap-IN admission: scatter a parked record's pages into
        freshly allocated device pages, then rejoin via the standard
        suffix-prefill path (``_first_chunk`` re-prefills the one
        unwritten last context token, installing the block-table row
        and pos) — token-identical to the recompute resume at a page
        transfer instead of a full re-prefill.  Returns a status:
        "admitted" (with the remaining budget), "wait" (FCFS — pages
        or budget short, retry next iteration), or "miss" (record
        stale/unusable and dropped; caller admits cold)."""
        page = self.cfg.page_size
        rec = self.host_pool.peek(key)
        plen = len(req.prompt)
        if (plen <= rec.written
                or not np.array_equal(req.prompt[:len(rec.context)],
                                      rec.context)):
            # prompt does not extend the parked context: stale record
            self.host_pool.drop(key)
            self.stats["idle_drops"] += 1
            return ("miss", budget)
        if budget is not None and self._chunk_quota(budget) == 0:
            return ("wait", budget)
        need = pc.pages_needed(plen, page)
        if self.ring:
            # the rejoined stream is ring-bounded like any other slot;
            # a turn extending past the ring wraps over the scattered
            # pages in entry order (all freshly allocated — exclusive)
            need = min(need, self.layout.slots_pages(self.cfg.max_seq))
        n_total = max(need, rec.n_pages)
        headroom = self.num_active
        if not self._reserve(n_total + headroom):
            if self.num_active == 0:
                # nothing will ever free pages — degrade to the cold
                # path, whose own attempt ladder is guaranteed to
                # terminate (submit() checked the solo fit)
                self.host_pool.drop(key)
                return ("miss", budget)
            return ("wait", budget)
        self.queue.popleft()
        pages = self.alloc.alloc(n_total)
        try:
            self.backend.swap_in(rec.blob, pages[:rec.n_pages])
        except Exception:
            # zero-lost: restore the head; the record stays parked for
            # the retry (or dies with the replica)
            self.alloc.free(pages)
            self.queue.appendleft(req)
            raise
        self.host_pool.take(key)
        slot = _Slot(req.uid, req.prompt, plen, req.max_new_tokens, pages,
                     -1, self._admit_seq, [], None, prefilled=rec.written,
                     deadline_s=req.deadline_s, retries_left=req.retries,
                     arrival_t=req.arrival_t, session=req.session,
                     abs_pages=max(pc.pages_needed(plen, page), n_total))
        self.slots[i] = slot
        self._admit_seq += 1
        self.stats["admitted"] += 1
        self.stats["swap_ins"] += 1
        self.stats["swapped_in_pages"] += rec.n_pages
        if req.uid in self._resume:
            # swapped-out preemption victim: count like recompute
            # resumes (the prompt includes prior output), not honest
            # new-prompt traffic
            self.stats["recompute_prompt_tokens"] += plen
            self.stats["recompute_hit_tokens"] += rec.written
        else:
            self.stats["session_prompt_tokens"] += plen
            self.stats["session_hit_tokens"] += rec.written
        try:
            budget = self._first_chunk(i, budget, rec.written)
        except Exception:
            self.alloc.free(slot.pages)
            self.slots[i] = None
            self.queue.appendleft(req)
            raise
        return ("admitted", budget)

    def _admit(self) -> None:
        page = self.cfg.page_size
        row_len = self.layout.slots_pages(self.cfg.max_seq)
        budget = (self.cfg.prefill_chunk_tokens
                  if self.cfg.prefill_chunk_tokens else None)
        budget = self._continue_prefills(budget)
        budget = self._try_resume_idle(budget)
        for i, slot in enumerate(self.slots):
            if slot is not None or not self.queue:
                continue
            if budget is not None and self._chunk_quota(budget) == 0:
                break                 # this iteration's prefill budget spent
            req = self.queue[0]
            if (req.session is not None and req.uid not in self._resume
                    and self._find_idle(req.session) is not None):
                break   # head rejoins its live idle slot once budget allows
            key = self._parked_key(req)
            if key is not None:
                status, budget = self._admit_swapped(i, req, key, budget)
                if status == "admitted":
                    continue
                if status == "wait":
                    break             # FCFS: don't starve the head
                # "miss": record dropped — fall through to cold admission
            plen = len(req.prompt)
            n_prompt_pages = pc.pages_needed(plen, page)
            # ring KV: the slot holds at most the ring capacity — a
            # prompt wider than that wraps over its own entries during
            # prefill (the scatter routes below-horizon rows to the
            # null page), so admission allocates O(window) pages however
            # long the prompt
            n_slot_pages = (min(n_prompt_pages, row_len) if self.ring
                            else n_prompt_pages)
            match = (self.prefix_cache.lookup(req.prompt)
                     if self.prefix_cache is not None
                     else pc.PrefixMatch([], None, 0))
            if self.ring and n_prompt_pages > row_len:
                # the prompt wraps before prefill completes: matched
                # flat prefix pages cannot sit at ring entries (entry j
                # must end up holding the LAST absolute page ≡ j mod R)
                # — skip reuse rather than install a wrong layout
                match = pc.PrefixMatch([], None, 0)
            # Try the richest reuse first; with live slots a failed
            # reserve just WAITS (they finish and free pages, and the
            # matched entries survive for the retry).  With NO live
            # slots nothing will ever free pages, so waiting would
            # livelock when the pins themselves make the last needed
            # pages unevictable — degrade instead: dropping the
            # partial, then the full match, releases those pins so
            # `_reserve` can evict them as plain store pages (submit()
            # guarantees the no-reuse plan fits solo, so the ladder
            # terminates).
            attempts = [(match.full_pages, match.partial, match.tokens)]
            if self.num_active == 0:
                if match.partial is not None:
                    attempts.append((match.full_pages, None,
                                     len(match.full_pages) * page))
                if match.full_pages:
                    attempts.append(([], None, 0))
            # headroom: one page per live slot, so a fresh admission
            # can't grab the exact pages an older slot's next page-
            # boundary crossing needs (which would make the newcomer
            # the immediate preemption victim and burn its prefill)
            headroom = self.num_active
            plan = None
            for full_pages, partial, matched in attempts:
                pinned = list(full_pages)
                if partial is not None:
                    pinned.append(partial[0])
                if pinned:
                    self.alloc.share(pinned)
                fresh_needed = n_slot_pages - len(full_pages)
                if self._reserve(fresh_needed + headroom):
                    plan = (full_pages, partial, matched, fresh_needed)
                    break
                if pinned:
                    self.alloc.free(pinned)
            if plan is None:
                break                     # FCFS: don't starve the head
            full_pages, partial, matched, fresh_needed = plan
            self.queue.popleft()
            fresh = self.alloc.alloc(fresh_needed)
            pages = full_pages + fresh
            cow_src = partial[0] if partial is not None else None
            try:
                if partial is not None:
                    self.backend.copy_page(cow_src, fresh[0])
                    self.alloc.free([cow_src])  # drop the temp CoW pin
                    cow_src = None
                    self.stats["cow_copies"] += 1

                row = np.full((row_len,), pc.NULL_PAGE, np.int32)
                row[:len(pages)] = pages
                suffix_len = plen - matched
                # first prefill chunk this iteration: the whole suffix
                # when unbudgeted (or it fits), else the widest bucket
                # the remaining budget buys — the rest carries across
                # iterations
                chunk = (suffix_len if budget is None
                         else min(suffix_len, self._chunk_quota(budget)))
                if chunk == suffix_len and matched == 0:
                    spad = _bucket(plen, page, self.cfg.max_seq)
                    assert spad // page >= n_prompt_pages, \
                        "bucket narrower than the prompt's pages"
                    padded = np.zeros((1, spad), np.int32)
                    padded[0, :plen] = req.prompt
                    tok0 = self.backend.admit_full(padded, i, plen, row)
                else:
                    spad = _bucket(chunk, page, self.cfg.max_seq)
                    padded = np.zeros((1, spad), np.int32)
                    padded[0, :chunk] = req.prompt[matched:matched + chunk]
                    npp = (row_len if self.ring else
                           _pow2_pages(pc.pages_needed(matched, page),
                                       row_len))
                    tok0 = (self.backend.admit_prefix(
                                padded, i, matched, chunk, row,
                                n_prefix_pages=npp)
                            if chunk == suffix_len else
                            self.backend.prefill_chunk(
                                padded, i, matched, chunk, row,
                                n_prefix_pages=npp))
            except Exception:
                # zero-lost invariant: a backend dying MID-ADMISSION
                # must not strand the popped request — restore it to
                # the queue head and return every page ref this
                # admission took, then surface the fault to the
                # router's health check
                if cow_src is not None:
                    self.alloc.free([cow_src])
                self.alloc.free(pages)
                self.queue.appendleft(req)
                raise
            if budget is not None:
                budget -= spad
            slot = _Slot(req.uid, req.prompt, plen, req.max_new_tokens,
                         pages, -1, self._admit_seq, [], None,
                         prefilled=matched + chunk,
                         deadline_s=req.deadline_s, retries_left=req.retries,
                         arrival_t=req.arrival_t, session=req.session,
                         abs_pages=n_prompt_pages)
            self.slots[i] = slot
            self._admit_seq += 1
            self.stats["admitted"] += 1
            self.stats["prefill_tokens"] += chunk
            if req.uid in self._resume:
                # recompute re-prefill: the prompt includes prior output
                # and the match mostly re-hits this request's own pages
                # — keep it out of the honest prompt/hit-rate counters
                self.stats["recompute_prompt_tokens"] += plen
                self.stats["recompute_hit_tokens"] += matched
            else:
                self.stats["prompt_tokens"] += plen
                self.stats["prefix_hit_tokens"] += matched
            if slot.prefilling:
                self.stats["prefill_chunks"] += 1
            else:
                self._complete_prefill(slot, tok0)

    def _ring_extend(self, slot: _Slot, need_abs: int,
                     updates: Optional[List[tuple]] = None,
                     headroom: int = 0) -> bool:
        """Advance a ring slot's entries until its context covers
        ``need_abs`` absolute pages.  While the slot is still filling
        its ring (len(pages) < R) this appends pages exactly like flat
        growth.  Once the ring is full, advancing over an entry whose
        page this slot owns EXCLUSIVELY recycles the physical page in
        place — no allocation, no block-table write, the out-of-window
        rows simply get overwritten (the kernel's ring token math masks
        them the moment the write head enters the new absolute page).
        An entry still SHARED (prefix store, another slot) is never
        stolen: this slot drops its reference and installs a fresh page
        at the entry, so every other holder keeps the original bytes.
        ``updates`` (when given) collects (entry, page) block-table
        writes for entries whose physical page changed.  Returns False
        when an allocation is needed but ``_reserve`` cannot make room
        (partial progress is kept — callers escalate and retry).

        Flat engines run the same code: their ring capacity IS the
        full per-slot page count, so only the append branch ever
        executes and growth is byte-identical to the pre-ring path."""
        R = self.layout.slots_pages(self.cfg.max_seq)
        while slot.abs_pages < need_abs:
            if len(slot.pages) < R:
                if not self._reserve(1 + headroom):
                    return False
                pg = self.alloc.alloc(1)[0]
                slot.pages.append(pg)
                if updates is not None:
                    updates.append((len(slot.pages) - 1, pg))
                slot.abs_pages += 1
                continue
            e = slot.abs_pages % R
            old = slot.pages[e]
            if self.alloc.refcount(old) == 1:
                slot.abs_pages += 1      # exclusive: recycle in place
                self.stats["ring_recycled_pages"] += 1
                continue
            if not self._reserve(1 + headroom):
                return False
            pg = self.alloc.alloc(1)[0]
            self.alloc.free([old])       # drop OUR ref; holders keep it
            slot.pages[e] = pg
            if updates is not None:
                updates.append((e, pg))
            slot.abs_pages += 1
            self.stats["ring_shared_released"] += 1
        return True

    def _grow(self, window: Optional[Dict[int, int]] = None) -> None:
        """Lazy decode allocation: give every live slot the page(s) its
        next KV write lands in, escalating free-list pressure to
        prefix-store eviction and then preemption of the newest slot.
        ``window`` maps slot index -> decode-window width (speculative
        verify writes ``w`` consecutive rows, which can cross a page
        boundary); default is the plain one-token step."""
        page = self.cfg.page_size
        updates: List[tuple] = []           # (slot_row, page_idx, page_id)
        for i in sorted(range(len(self.slots)),
                        key=lambda j: (self.slots[j].admit_seq
                                       if self.slots[j] else -1)):
            slot = self.slots[i]
            if slot is None or slot.done or slot.prefilling:
                # mid-prefill slots write no decode KV: their prompt
                # pages were reserved at admission and their next chunk
                # brings its own block-table row
                continue
            w = window.get(i, 1) if window is not None else 1
            write_pos = slot.prompt_len + len(slot.generated) - 1
            need_abs = (write_pos + w - 1) // page + 1
            while slot is self.slots[i] and slot.abs_pages < need_abs:
                ups: List[tuple] = []
                ok = self._ring_extend(slot, need_abs, updates=ups)
                updates.extend((i, e, pg) for e, pg in ups)
                if ok:
                    break
                victim = self._pick_victim()
                assert victim is not None    # slot i itself is live
                # drop any block-table updates queued for the victim
                updates = [u for u in updates if u[0] != victim]
                # evict→SWAP→preempt: park the victim's KV in the host
                # pool when it fits (resume = scatter + 1-token rejoin),
                # recompute-preempt only when the host tier is dry too
                if not self._swap_out(victim):
                    self._preempt(victim)
        if updates:
            self.backend.write_block_entries(updates)

    def _session_held(self, session: int, exclude: int) -> bool:
        """True when the session already has keep-alive state somewhere
        else — another slot or a parked record (stale duplicates would
        make resume ambiguous)."""
        for j, s in enumerate(self.slots):
            if j != exclude and s is not None and s.session == session:
                return True
        return (self.host_pool is not None
                and ("sess", session) in self.host_pool)

    def _finish(self, completions: List[Completion]) -> None:
        for i, slot in enumerate(self.slots):
            if slot is None or slot.idle or not slot.done:
                continue
            if (slot.session is not None
                    and not self._session_held(slot.session, i)):
                # session keep-alive: emit the turn's completion but
                # HOLD the slot idle — pages and device KV stay, so the
                # next turn rejoins with a one-token suffix prefill.
                # Pressure (_reserve) or the idle timer parks it to the
                # host pool; end_session() releases it for good.
                res = self._resume.pop(slot.uid, None)
                prior = res.prior if res is not None else []
                plen0 = (res.orig_prompt_len if res is not None
                         else slot.prompt_len)
                toks = prior + slot.generated[:slot.max_new]
                completions.append(Completion(
                    slot.uid, plen0, np.asarray(toks, np.int32)))
                # reset the backend row/pos NOW: inactive lanes still
                # WRITE junk KV every decode step (at their pinned pos
                # 0), and only a NULL block-table row steers those
                # writes onto the sacrificial null page instead of this
                # slot's held pages.  Rejoin reinstalls row + pos via
                # the suffix prefill, so nothing is lost.
                self.backend.release_slot(i)
                slot.idle = True
                slot.idle_since = self.stats["iterations"]
                self.stats["finished"] += 1
                continue
            self.backend.release_slot(i)  # device first (see _preempt)
            self.alloc.free(slot.pages)
            res = self._resume.pop(slot.uid, None)
            prior = res.prior if res is not None else []
            plen0 = res.orig_prompt_len if res is not None else slot.prompt_len
            toks = prior + slot.generated[:slot.max_new]
            completions.append(Completion(
                slot.uid, plen0, np.asarray(toks, np.int32)))
            self.slots[i] = None
            self.stats["finished"] += 1

    def end_session(self, session: int) -> None:
        """Release a session's keep-alive state: the live idle slot's
        device pages and/or its parked host record.  Drivers call this
        after a conversation's last turn; without it the session holds
        its tier until pressure parks and eventually drops it."""
        i = self._find_idle(session)
        if i is not None:
            slot = self.slots[i]
            self.backend.release_slot(i)
            self.alloc.free(slot.pages)
            self.slots[i] = None
        if self.host_pool is not None:
            self.host_pool.drop(("sess", session))

    def check_invariants(self) -> None:
        """Audit mode (``SchedulerConfig.debug_invariants``): allocator
        + host-pool invariants plus slot/page cross-checks, run after
        every ``step()`` so a refcount bug surfaces at the iteration
        that caused it rather than at drain."""
        self.alloc.check()
        if self.host_pool is not None:
            self.host_pool.check()
        R = self.layout.slots_pages(self.cfg.max_seq)
        for s in self.slots:
            if s is None:
                continue
            assert len(set(s.pages)) == len(s.pages), \
                f"slot {s.uid} holds duplicate pages: {s.pages}"
            for p in s.pages:
                assert p != pc.NULL_PAGE and self.alloc.refcount(p) >= 1, \
                    f"slot {s.uid} references free/null page {p}"
            if s.idle:
                assert s.session is not None and s.done, \
                    f"idle slot {s.uid} without a finished session turn"
            # ring bound: no slot ever holds more than the ring
            # capacity, and a wrapped counter only exists on a FULL
            # ring (the append phase keeps abs == held)
            assert len(s.pages) <= R, \
                f"slot {s.uid} holds {len(s.pages)} pages > ring cap {R}"
            assert s.abs_pages == len(s.pages) or len(s.pages) == R, \
                (f"slot {s.uid} wrapped (abs={s.abs_pages}) with a "
                 f"part-filled ring ({len(s.pages)}/{R})")
            if not self.ring:
                assert s.abs_pages == len(s.pages), \
                    f"flat slot {s.uid} abs_pages {s.abs_pages} != " \
                    f"{len(s.pages)} held"

    def step(self) -> List[Completion]:
        """Grow + admit + decode one WINDOW (one token unless speculating)
        for every live slot; returns the requests that finished this
        iteration.  Growth runs FIRST so existing slots claim their next
        decode page before a new admission can take it (paired with the
        admission headroom, this keeps a just-prefilled newcomer from
        being the instant victim); a second growth pass covers newcomers
        whose page-aligned prompt makes their first decode write start a
        fresh page — and, under speculation, every slot's drafted window
        width (a verify step scatters up to ``spec_k`` rows).
        """
        completions = self._step_impl()
        if self.cfg.debug_invariants:
            self.check_invariants()
        return completions

    def _park_idle_expired(self) -> None:
        """Idle-timer parking: once a session slot has sat idle for
        ``idle_park_iterations`` scheduler iterations, move its KV to
        the host pool proactively — long gaps between chat turns should
        not hold device pages hostage.  Sessions with a turn already
        queued are skipped (parking them would buy a pointless
        round trip)."""
        if self.host_pool is None or self.cfg.idle_park_iterations <= 0:
            return
        idle = self._idle_slots_lru()
        if not idle:
            return
        waiting = {r.session for r in self.queue if r.session is not None}
        for i in idle:
            slot = self.slots[i]
            if slot.session in waiting:
                continue
            if (self.stats["iterations"] - slot.idle_since
                    >= self.cfg.idle_park_iterations):
                self._park_idle(i)

    def _step_impl(self) -> List[Completion]:
        completions: List[Completion] = []
        self._shed_expired(completions)   # deadline-expired queued work
        self._park_idle_expired()         # idle sessions past the timer
        self._grow()                      # may preempt; slots can change
        self._admit()
        self._finish(completions)         # max_new == 1 finishes at prefill
        if self.num_active == 0:
            return completions
        K = max(1, self.cfg.spec_k)
        # draft a window per live slot: the last committed token plus up
        # to K-1 prompt-lookup drafts, capped by the remaining budget so
        # a verify step never writes KV past what the request may emit
        windows: Dict[int, List[int]] = {}
        for i, slot in enumerate(self.slots):
            if slot is None or slot.done or slot.prefilling:
                continue                  # mid-prefill: no token to decode yet
            win = [slot.last_token]
            rem = slot.max_new - len(slot.generated)
            if K > 1 and slot.draft is not None and rem > 1:
                win += slot.draft.propose(min(K, rem) - 1)
            windows[i] = win
        self._grow(window={i: len(w) for i, w in windows.items()})
        B = self.cfg.max_slots
        tokens = np.zeros((B, K), np.int32)
        active = np.zeros((B,), np.int32)
        lens = np.zeros((B,), np.int32)
        for i, slot in enumerate(self.slots):
            # _grow may have preempted a drafted slot (then slots[i] is
            # None until the next admission pass) — skip its window
            if slot is None or slot.done or i not in windows:
                continue
            win = windows[i]
            tokens[i, :len(win)] = win
            lens[i] = len(win)
            active[i] = 1
        if not active.any():
            return completions
        out, n_emit, okf = (self.backend.decode(tokens, active) if K == 1
                            else self.backend.decode(tokens, active, lens))
        for i, slot in enumerate(self.slots):
            if slot is None or not active[i]:
                continue
            if not int(okf[i]):
                # NaN guard: this slot's logits held NaN/inf — nothing
                # it sampled this step may commit (retry or fail typed)
                self._fail_slot(i, completions)
                continue
            ne = int(n_emit[i])
            emitted = [int(t) for t in out[i, :ne]]
            slot.generated.extend(emitted)
            slot.last_token = emitted[-1]
            if slot.draft is not None:
                slot.draft.extend(emitted)
            self.stats["decode_tokens"] += ne
            if lens[i] > 1:
                self.stats["spec_steps"] += 1
                self.stats["spec_drafted"] += int(lens[i]) - 1
                self.stats["spec_accepted"] += ne - 1
        usable = self.layout.num_pages - 1
        self.stats["occupancy_sum"] += (usable - self.alloc.free_pages) / usable
        self.stats["iterations"] += 1
        self._finish(completions)
        return completions

    def run(self, requests: List[Request]) -> List[Completion]:
        """Drain a whole workload; completions come back sorted by uid."""
        for r in requests:
            self.submit(r)
        done: List[Completion] = []
        while self.queue or self.num_active:
            done.extend(self.step())
        self.alloc.check()
        return sorted(done, key=lambda c: c.uid)
