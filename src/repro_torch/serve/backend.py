"""Paged-KV serving backend: the DEVICE half of the host/device split.

The continuous-batching scheduler (``serve/scheduler.py``) is pure host
state and drives the device through the ``PagedKVBackend`` interface
below (the interface of ``repro.serve.backend``).  ``SingleDeviceBackend``
holds the whole page pool on one torch device and runs the model
eagerly: cold admission (``lm.prefill`` + ``scatter_prompt_pages``; its
attention is the flash kernel with ``attention_impl="pallas"``), suffix
prefill (``lm.prefill_paged``), the K=1 decode step
(``lm.decode_step_paged``) and the speculative verify step
(``lm.decode_window_paged`` with on-device greedy acceptance), whose
attention and quantized matmuls are the CUDA kernels on a CUDA device,
copy-on-write, slot release and the host swap tier.  Pools are updated
in place.

A uniformly sliding-window stack (every layer ``attn_local``, e.g.
Gemma3 cut to its first five layers) gets RING block tables of
``ring_pages(window, page, spec_k)`` entries per slot unless
``cfg.windowed_kv`` is False (``paged_cache.ring_window``): absolute
page q lives at entry ``q % R`` in every step, so a slot's KV stays
O(window) however long its stream runs.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.model_config import ModelSpec
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.serve import paged_cache as pc

class PagedKVBackend:
    """Interface the scheduler drives; implementations own the device
    cache and the steps.  All token returns are host ints / numpy — the
    scheduler never touches device tensors."""

    spec: ModelSpec
    layout: lm.PagedLayout
    plan: Any                      # analytical PagedCachePlan
    cache: Any                     # device cache (pools + block tables)
    tp: int = 1                    # tensor-parallel degree (1 = single)

    def admit_full(self, padded_tokens: np.ndarray, slot: int,
                   true_len: int, bt_row: np.ndarray) -> int:
        """Cold prefill of a bucket-padded prompt into ``slot``; returns
        the sampled first token."""
        raise NotImplementedError

    def admit_prefix(self, padded_suffix: np.ndarray, slot: int,
                     prefix_len: int, true_len: int, bt_row: np.ndarray,
                     *, n_prefix_pages: int) -> int:
        """Suffix-only prefill against cached prefix pages."""
        raise NotImplementedError

    def prefill_chunk(self, padded_chunk: np.ndarray, slot: int,
                      prefix_len: int, true_len: int, bt_row: np.ndarray,
                      *, n_prefix_pages: int) -> int:
        """One chunk of a chunked prefill: the suffix-prefill program over
        the rows already written; the returned token counts only for the
        final chunk."""
        raise NotImplementedError

    def decode(self, tokens: np.ndarray, active: np.ndarray,
               lens: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One batched decode step: ``tokens`` (B, K), returns
        ``(out (B, K), n_emit (B,), ok (B,))`` where ``ok`` is 0 for a slot
        whose logits held NaN/inf."""
        raise NotImplementedError

    def copy_page(self, src_page: int, dst_page: int) -> None:
        """Copy one physical page (all layers, k/v and scales)."""
        raise NotImplementedError

    def release_slot(self, slot: int) -> None:
        """Reset a finished/preempted slot's block table and position."""
        raise NotImplementedError

    def write_block_entries(self,
                            updates: Sequence[Tuple[int, int, int]]) -> None:
        """Install lazily-grown decode pages: (slot_row, page_idx,
        page_id) triples into the block tables."""
        raise NotImplementedError

    def swap_out(self, page_ids: Sequence[int]) -> Any:
        """Gather the listed pages (all layers, k/v pools + scale pages)
        into a host numpy tree; the device pages are untouched."""
        raise NotImplementedError

    def swap_in(self, blob: Any, page_ids: Sequence[int]) -> None:
        """Scatter a previously gathered blob into ``page_ids``
        (byte-identical round trip with ``swap_out``)."""
        raise NotImplementedError

    def host_page_bytes(self) -> int:
        """Host bytes one page occupies when parked (all layers, k/v
        pools + scale pages)."""
        raise NotImplementedError


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree.to(device)


class SingleDeviceBackend(PagedKVBackend):
    """The whole page pool on one torch device.  ``device`` defaults to
    ``cuda`` and raises when there is none."""

    def __init__(self, params: Any, spec: ModelSpec, cfg, *, device=None):
        # uniformly sliding-window stacks get a ring block table bounded
        # at O(window) pages per slot (unless cfg.windowed_kv forces the
        # mask-only reference); everything else keeps the flat layout
        self.window = pc.ring_window(spec, getattr(cfg, "windowed_kv", None))
        self.ring = self.window > 0
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device)
        self.spec, self.cfg = spec, cfg
        self.layout = pc.make_layout(
            spec, max_seq=cfg.max_seq, page_size=cfg.page_size,
            num_pages=cfg.num_pages, kv_budget_bytes=cfg.kv_budget_bytes,
            cache_dtype=cfg.cache_dtype, max_slots=cfg.max_slots,
            tp=self.tp, window=self.window,
            spec_k=getattr(cfg, "spec_k", 1))
        self.plan = pc.plan_for_layout(spec, self.layout, cfg.cache_dtype)
        self.cache = lm.init_paged_cache(spec, cfg.max_slots, cfg.max_seq,
                                         self.layout, cfg.cache_dtype,
                                         device=self.device)
        #: decode steps run (batched K=1 steps and K-token verify steps)
        self.decode_steps = 0
        #: cold admissions run (full-prompt ``lm.prefill``)
        self.cold_admissions = 0

    def _tensor(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    @torch.no_grad()
    def admit_full(self, padded_tokens, slot, true_len, bt_row) -> int:
        self.cold_admissions += 1
        tokens = self._tensor(padded_tokens, torch.int64)
        logits, pre = lm.prefill(self.params, self.spec, {"tokens": tokens},
                                 max_seq=tokens.shape[1],
                                 impl=self.cfg.attention_impl,
                                 true_len=true_len)
        page = lm.paged_page_size(self.cache)
        n = tokens.shape[1] // page                  # prompt pages
        row = self._tensor(bt_row)
        if self.ring:
            # absolute prompt page q goes to entry q % R when it lies in
            # the last R pages (the window can read no other), else to
            # the null page, as do the padding pages past true_len
            R = row.shape[0]
            apg = torch.arange(n, device=self.device)
            last_pg = (true_len - 1) // page
            keep = (apg > last_pg - R) & (apg <= last_pg)
            pv = torch.where(keep, row[apg % R], torch.zeros_like(row[:1]))
        else:
            pv = row[:n]
        pc.scatter_prompt_pages(self.cache["groups"], pre["groups"], pv, page)
        self.cache["pos"][slot] = true_len
        self.cache["block_tables"][slot] = row
        return int(torch.argmax(logits[0, 0]))

    @torch.no_grad()
    def admit_prefix(self, padded_suffix, slot, prefix_len, true_len,
                     bt_row, *, n_prefix_pages) -> int:
        logits, _ = lm.prefill_paged(
            self.params, self.spec, self._tensor(padded_suffix, torch.int64),
            self.cache, slot, self._tensor(bt_row), prefix_len, true_len,
            n_prefix_pages=n_prefix_pages, ring=self.ring)
        return int(torch.argmax(logits[0, 0]))

    def prefill_chunk(self, padded_chunk, slot, prefix_len, true_len,
                      bt_row, *, n_prefix_pages) -> int:
        # the chunk program IS the suffix-prefill program (prefix = the
        # rows already written)
        return self.admit_prefix(padded_chunk, slot, prefix_len, true_len,
                                 bt_row, n_prefix_pages=n_prefix_pages)

    @torch.no_grad()
    def decode(self, tokens, active, lens=None):
        if lens is None and tokens.shape[1] != 1:
            raise ValueError(f"a {tokens.shape[1]}-token window needs lens")
        self.decode_steps += 1
        if lens is not None:
            return self._decode_window(tokens, active, lens)
        act = self._tensor(active)
        logits, self.cache = lm.decode_step_paged(
            self.params, self.spec, self.cache,
            self._tensor(tokens, torch.int64), ring=self.ring)
        # pin inactive slots at pos 0 so their block-table lookups stay on
        # the null page
        self.cache["pos"] = self.cache["pos"] * act
        # per-slot finite-logits flag: the scheduler fails a slot whose
        # logits held NaN/inf instead of committing its token
        finite = torch.all(torch.isfinite(logits[:, 0]), dim=-1).to(torch.int32)
        nxt = torch.argmax(logits[:, 0], dim=-1)
        return (nxt.cpu().numpy()[:, None].astype(np.int32),
                np.asarray(active, np.int32), finite.cpu().numpy())

    def _decode_window(self, tokens, active, lens):
        """The fused speculative verify step: score a K-token window per
        slot (last committed token + K-1 drafts), greedy-accept the drafts
        on the device and advance each slot's ``pos`` by exactly the
        emitted count, the rollback that keeps rejected-draft K/V outside
        the valid context.  Returns (out (B, K) greedy token per window
        position, n_emit (B,) accepted drafts + the bonus token, ok (B,)
        1 where every REAL window position's logits are finite); only
        these integers cross to the host, in one copy."""
        tok = self._tensor(tokens, torch.int64)
        act = self._tensor(active)
        ln = self._tensor(lens)
        pos0 = self.cache["pos"]
        logits, self.cache = lm.decode_window_paged(
            self.params, self.spec, self.cache, tok, ln, ring=self.ring)
        out = torch.argmax(logits, dim=-1)                      # (B, K)
        K = tok.shape[1]
        j = torch.arange(K - 1, device=self.device)
        ok = (tok[:, 1:] == out[:, :-1]) & (j[None] < ln[:, None] - 1)
        accepted = torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1)
        n_emit = (accepted + 1) * act
        self.cache["pos"] = ((pos0 + n_emit) * act).to(torch.int32)
        # finite check over the real window positions only (padded
        # positions score pad tokens, which never commit)
        pos_ok = torch.all(torch.isfinite(logits), dim=-1)     # (B, K)
        real = torch.arange(K, device=self.device)[None] < ln[:, None]
        finite = torch.all(pos_ok | ~real, dim=1)
        host = torch.cat([out, n_emit[:, None].to(out.dtype),
                          finite[:, None].to(out.dtype)], dim=1).cpu().numpy()
        return (host[:, :K].astype(np.int32), host[:, K].astype(np.int32),
                host[:, K + 1].astype(np.int32))

    def copy_page(self, src_page: int, dst_page: int) -> None:
        pc.copy_page(self.cache, src_page, dst_page)

    def release_slot(self, slot: int) -> None:
        pc.release_slot(self.cache, slot)

    def write_block_entries(self, updates) -> None:
        rows = [u[0] for u in updates]
        cols = [u[1] for u in updates]
        self.cache["block_tables"][rows, cols] = self._tensor(
            [u[2] for u in updates])

    def swap_out(self, page_ids) -> Any:
        pv = torch.as_tensor(list(page_ids), dtype=torch.int64,
                             device=self.device)
        return [[{name: entry[name][pv].cpu().numpy() for name in entry}
                 for entry in cg] for cg in self.cache["groups"]]

    def swap_in(self, blob, page_ids) -> None:
        pv = torch.as_tensor(list(page_ids), dtype=torch.int64,
                             device=self.device)
        for cg, rg in zip(self.cache["groups"], blob):
            for entry, src in zip(cg, rg):
                for name in entry:
                    entry[name][pv] = torch.as_tensor(
                        src[name][:len(page_ids)], device=self.device)

    def host_page_bytes(self) -> int:
        return sum(t.element_size() * t.numel() // t.shape[0]
                   for cg in self.cache["groups"] for entry in cg
                   for t in entry.values())

