"""Paged-KV byte accounting (the subset of ``repro.core.analytical``
that ``serve/paged_cache.py`` sizes its pools with).

The functions are the JAX package's text: the page pools of the port
keep the same layouts, so they take the same bytes.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.model_config import ModelSpec


@dataclass
class MemoryBreakdown:
    weights: float = 0.0
    activations: float = 0.0
    kv_cache: float = 0.0
    optimizer: float = 0.0
    gradients: float = 0.0

    @property
    def total(self) -> float:
        return (self.weights + self.activations + self.kv_cache
                + self.optimizer + self.gradients)


@dataclass(frozen=True)
class PagedCachePlan:
    """Sizing of a block-table paged KV cache inside a byte budget.

    One logical page covers ``page_size`` token positions across ALL
    attention layers (each layer owns its own k/v pool slice of the
    page), so ``page_bytes`` already sums over layers.  Page 0 is the
    reserved null page inactive slots point at, hence ``usable_pages``.

    ``tp`` > 1 marks the byte fields as the PER-DEVICE share of a
    KV-head-sharded pool (``plan_paged_cache(tp=)``) — consumers that
    take their own ``tp`` knob (``latency.mixed_iteration_cost`` /
    ``predict_serve_throughput``) reject such plans instead of
    silently dividing the pool bytes twice.
    """
    page_size: int
    num_pages: int
    page_bytes: float              # bytes per page across all attn layers
    bytes_per_token: float         # page_bytes / page_size
    tp: int = 1                    # >1: byte fields are per-device shares

    @property
    def usable_pages(self) -> int:
        return max(0, self.num_pages - 1)

    @property
    def max_tokens(self) -> int:
        return self.usable_pages * self.page_size

    @property
    def total_bytes(self) -> float:
        return self.num_pages * self.page_bytes


# Stored bytes per KV value + whether per-token-per-head f32 scales ride
# along, per paged-cache dtype.  int4 nibble-packs two tokens per byte
# (0.5 B/value); quantized layouts carry one f32 scale per token per kv
# head per k/v pool — the overhead that keeps the paper's "4-bit cuts
# memory 60-70%" claim honest instead of a naive 8x.  Scale pages are
# stored (P, KV, page), token dim last, as in the JAX package.
KV_CACHE_DTYPES = {"fp32": (4.0, False), "int8": (1.0, True),
                   "int4": (0.5, True)}


def tp_shards_kv(spec: ModelSpec, tp: int) -> bool:
    """True iff a model-axis of size ``tp`` actually shards the paged KV
    pools (divides both head counts), the policy of the JAX package's
    sharded backend.  Non-divisible counts replicate the pools, so per-device byte/traffic
    models must NOT divide by tp for them."""
    return tp > 1 and spec.num_kv_heads % tp == 0 and spec.num_heads % tp == 0


def kv_cache_dtype_bytes(cache_dtype: str):
    """(bytes per stored KV value, scales present) for a paged-cache
    dtype name — the one mapping every byte-accounting consumer
    (layout sizing, iteration model, benchmarks) shares."""
    try:
        return KV_CACHE_DTYPES[cache_dtype]
    except KeyError:
        raise ValueError(f"cache dtype {cache_dtype!r} "
                         f"(want {sorted(KV_CACHE_DTYPES)})") from None


def page_bytes(spec: ModelSpec, page_size: int, bytes_per: float = 2.0,
               quantized_scales: bool = False, tp: int = 1) -> float:
    """Bytes of one page across all attention layers (k and v pools).

    ``bytes_per`` is the stored element width (1.0 for int8 pages, 0.5
    for nibble-packed int4); ``quantized_scales`` adds the
    per-token-per-head f32 scale arrays the quantized layouts carry
    (see ``KV_CACHE_DTYPES``).  With ``tp`` > 1 this is the PER-DEVICE
    share of one page under tensor-parallel serving: the pools are
    partitioned over the KV-head dim, so each device stores KV/tp
    heads of every page — but ONLY when tp divides both head counts.
    A non-divisible count replicates the pools on every device, so the
    per-device share stays the full page; pricing it as a
    shard here would let budget-driven layouts overshoot the device
    by up to tp x.  The single source of truth for the paged layout's
    footprint — budget fitting and layout-matching plans both derive
    from it.
    """
    kv = spec.num_kv_heads
    if tp_shards_kv(spec, tp):
        kv //= tp
    row = kv * spec.head_dim * bytes_per
    if quantized_scales:
        row += kv * 4.0
    return 2.0 * spec.num_attention_layers() * page_size * row


def plan_paged_cache(spec: ModelSpec, budget_bytes: float,
                     page_size: int = 16, bytes_per: float = 2.0,
                     quantized_scales: bool = False,
                     tp: int = 1) -> PagedCachePlan:
    """Fit the largest page pool into ``budget_bytes``.

    ``budget_bytes`` is a PER-DEVICE budget; with ``tp`` > 1 each
    device holds only its KV-head slice of every page, so the same
    per-device budget addresses ~tp x more logical pages — the
    capacity win tensor-parallel paged serving exists for.  The
    returned plan's byte fields stay per-device.
    """
    pb = page_bytes(spec, page_size, bytes_per, quantized_scales, tp=tp)
    num_pages = int(budget_bytes // pb)
    if num_pages < 2:
        raise ValueError(
            f"KV budget {budget_bytes:.0f} B < 2 pages "
            f"({pb:.0f} B/page) for {spec.name}")
    return PagedCachePlan(page_size=page_size, num_pages=num_pages,
                          page_bytes=pb, bytes_per_token=pb / page_size,
                          tp=tp if tp_shards_kv(spec, tp) else 1)


def kv_budget(device_bytes: float, mem: MemoryBreakdown,
              reserve_frac: float = 0.05) -> float:
    """KV byte budget left after weights + activations (+ safety margin),
    the paper's §IV deployment constraint expressed for the serve path."""
    free = device_bytes * (1.0 - reserve_frac) - mem.weights - mem.activations
    if free <= 0:
        raise ValueError(
            f"no KV budget: weights+activations {mem.weights + mem.activations:.0f} B "
            f"exceed device {device_bytes:.0f} B")
    return free
