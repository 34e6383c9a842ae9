"""The split plan of the paged-attention kernel (``split_plan``): the grid
cuts each slot's block-table walk into runs of ``split_pages(page, D)``
entries and merges a slot's splits in ascending order, so a slot's
float sums, and its output, must not depend on the other slots of the
batch.  The plan is checked against the plain version's mask: it visits
exactly the entries that hold a key some query of the slot may see.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import paged_attention as pa

PAGE = 16
WINDOW = 48
MODES = ["full", "window", "ring"]


def _table(mode: str, K: int) -> int:
    """Block-table width: a ring of the window plus K - 1 newer tokens
    and the wrap-straddle page, else 33 flat entries."""
    return -(-(WINDOW + K - 1) // PAGE) + 1 if mode == "ring" else 33


def _seen_entries(length: int, n: int, K: int, mode: str):
    """Entries holding a key that some query of the slot may see, from
    the plain version's mask (queries at length - K .. length - 1)."""
    lengths = torch.tensor([length])
    if mode == "ring":
        pos = pa._ring_positions(lengths, n, PAGE)[0]
    else:
        pos = torch.arange(n * PAGE)
    qpos = torch.arange(length - K, length)[None]
    valid = (pos[:, None] >= 0) & (pos[:, None] <= qpos)
    if mode != "full":
        valid &= (qpos - pos[:, None]) < WINDOW
    return [e for e in range(n) if bool(valid[e * PAGE:(e + 1) * PAGE].any())]


@pytest.mark.parametrize("D", [64, 256])
@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("mode", MODES)
def test_split_plan_visits_exactly_the_seen_entries(mode, K, D):
    n = _table(mode, K)
    pps = pa.split_pages(PAGE, D)
    top = 5 * n * PAGE if mode == "ring" else n * PAGE
    for length in range(0, top + 1):
        (plan,) = pa.split_plan([length], n, PAGE, D, K=K,
                                window=WINDOW if mode != "full" else 0,
                                ring=mode == "ring")
        splits = [s for s, _ in plan]
        assert splits == sorted(set(splits))
        assert all(s * pps <= e < (s + 1) * pps for s, es in plan for e in es)
        assert all(s < pa.n_splits(n, PAGE, D) for s in splits)
        visited = [e for _, es in plan for e in es]
        assert visited == _seen_entries(length, n, K, mode), length


@pytest.mark.parametrize("D", [64, 256])
@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("mode", MODES)
def test_split_plan_is_per_slot(mode, K, D):
    """The same slot gets the same partition alone and in any batch, and
    the grid's split count reads only the table width and page size."""
    n = _table(mode, K)
    kw = dict(K=K, window=WINDOW if mode != "full" else 0, ring=mode == "ring")
    rng = np.random.default_rng(K)
    top = 5 * n * PAGE if mode == "ring" else n * PAGE
    for _ in range(50):
        batch = rng.integers(0, top + 1, size=int(rng.integers(1, 9)))
        plans = pa.split_plan(batch, n, PAGE, D, **kw)
        for length, plan in zip(batch, plans):
            assert plan == pa.split_plan([length], n, PAGE, D, **kw)[0]
        other = rng.permutation(np.concatenate([batch, rng.integers(0, top + 1, 3)]))
        by_len = dict(zip(other, pa.split_plan(other, n, PAGE, D, **kw)))
        for length, plan in zip(batch, plans):
            assert by_len[length] == plan
    assert pa.n_splits(n, PAGE, D) == -(-n // pa.split_pages(PAGE, D))
    # 16 tokens a split at D <= 64, 32 above: the page size and D alone
    assert pa.split_pages(PAGE, D) == (1 if D <= 64 else 2)
