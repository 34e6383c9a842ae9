"""The stream gate ``chip_smoke.py`` holds flash admission to against sdpa
admission: one parting may pass as a tie, and only when the two runs'
logits, MEASURED at the parting step and at every step before it, lie
within the prefill band (``PREFILL_TOL`` x the logit scale) and the two
parting tokens are the top two of both.  The synthetic runs below have
a 64-token vocabulary, 16 steps and a logit scale of 3.656; the
certified case is shaped like the parting seen on the card (top-2 gap
1.645e-4, measured difference 1.283e-4 at step 11).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(smoke)

V, STEPS, PART, SCALE = 64, 16, 11, 3.656


def _run_pair(seed: int, *, diff_at_part=1.283e-4, earlier_diff=1e-5,
              bad_step=None, third=False):
    """Two runs' (tokens, logit rows) that agree up to PART and part
    there: the reference b emits token 7 over token 3 by a gap of
    1.645e-4, run a (b plus measured differences) emits 3."""
    rng = np.random.default_rng(seed)
    lb = rng.uniform(-2.0, 2.0, size=(STEPS, V)).astype(np.float32)
    lb[:, 0] = -SCALE                               # the logit scale
    for t in range(STEPS):
        lb[t, 10 + t] = 3.0                         # a clear winner
    lb[PART, 10 + PART] = 0.0
    lb[PART, 7] = 3.5
    lb[PART, 3] = 3.5 - 1.645e-4
    if third:                                       # token 9 between them
        lb[PART, 9] = 3.5 - 0.8e-4
    la = lb + rng.uniform(-earlier_diff, earlier_diff, size=lb.shape
                          ).astype(np.float32)
    la[PART] = lb[PART]
    la[PART, 7] = lb[PART, 7] - diff_at_part
    la[PART, 3] = lb[PART, 3] + 0.3 * diff_at_part
    if third:
        la[PART, 9] = lb[PART, 9] - diff_at_part
    if bad_step is not None:
        la[bad_step, 1] = lb[bad_step, 1] + 1e-3    # > 3.656e-4, not a winner
    ta, tb = la.argmax(-1), lb.argmax(-1)
    assert (ta[:PART] == tb[:PART]).all() and ta[PART] == 3 and tb[PART] == 7
    # after the parting the contexts differ: other streams altogether
    ta[PART + 1:] = rng.integers(0, V, size=STEPS - PART - 1)
    return ta, tb, list(la), list(lb)


@pytest.mark.parametrize("case,want_failed,verdict", [
    ("tie", [], "certified tie"),
    ("over band at the parting", [0], "the measured difference exceeds"),
    ("over band before the parting", [0], "step 5 exceeded the band"),
    ("not the top two", [0], "not the top two"),
    ("second tie in one phase", [1], "a second tie in one phase"),
])
def test_tie_rule(case, want_failed, verdict):
    kw = {"over band at the parting": dict(diff_at_part=5e-4),
          "over band before the parting": dict(bad_step=5),
          "not the top two": dict(third=True)}.get(case, {})
    runs = [_run_pair(0, **kw)]
    if case == "second tie in one phase":
        runs.append(_run_pair(1))
    a, b, la, lb = (list(x) for x in zip(*runs))
    lines, failed = smoke.judge_partings(a, b, la, lb)
    assert failed == want_failed
    assert len(lines) == len(runs)
    assert verdict in lines[-1]
    assert f"parts at step {PART}: tokens 3 / 7" in lines[0]
    if case == "tie":
        ok, f = smoke.certify_tie(la[0], lb[0], PART, 3, 7)
        assert ok
        assert f["diff"] == pytest.approx(1.283e-4, rel=1e-3)
        assert f["band"] == pytest.approx(smoke.PREFILL_TOL * SCALE, rel=1e-6)
        assert f["gap_b"] == pytest.approx(1.645e-4, rel=1e-2)
        assert "1.645e-04" in lines[0] or "1.644e-04" in lines[0]


def test_streams_within_the_band_need_no_tie():
    """A late parting (matching prefix >= 0.9) passes on the band alone,
    however large the logit difference; equal streams report nothing."""
    ta, tb, la, lb = _run_pair(2, diff_at_part=5e-4)
    ta = np.concatenate([tb[:15], [ta[15]]])
    tb = np.concatenate([tb[:15], [tb[15] + 1]])
    lines, failed = smoke.judge_partings([ta, tb], [tb, tb], [la, lb], [lb, lb])
    assert failed == [] and len(lines) == 1 and "parts at step 15" in lines[0]
