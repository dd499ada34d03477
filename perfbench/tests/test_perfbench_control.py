"""The control comes out not correct: the reference put in the program's
place in float8 (``reference.Precision("fp8")``), on the same sample and
judged by the same rule and limits (``harness.judge``), fails the numbers
a cell compares where the program passes them.  Here at smoke size on the
CPU, under the smoke limits on the numbers the committed cells compare; at
the cells' own sizes, under their committed limits, on the card
(``test_perfbench_card``, through ``run.py --control``)."""

import time

import pytest

from perfbench.tests import smoke
from perfbench import harness

SEEDS = (2 ** 31 + 7, 2 ** 31 + 8, 2 ** 31 + 9)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", ["rwkv", "attn"])
def test_the_control_is_not_correct(kind, seed):
    c = smoke.cell(kind, limits=smoke.limits(kind))
    c["mix"].check_requests = 6
    r = harness.run_cell(harness.ROOT, c, seed, 2.0, False,
                         time.perf_counter(), device="cpu", control=True)
    assert r["correct"], r["check"]
    ctl = r["control"]
    assert ctl["correct"] is False, ctl["check"]
    assert set(ctl["check"]) == set(r["check"])
    for name, v in ctl["check"].items():
        assert v["limit"] == r["check"][name]["limit"]
        assert v["value"] > r["check"][name]["value"]


def test_a_control_under_its_limits_would_pass():
    """The verdict is the limits' own: with limits above the control's
    readings, the same control comes out correct."""
    readings = {"decode_gap_mean": 0.5, "decode_share_over_0.05": 0.9,
                "first_gap": 1.0, "decode_gap": 2.0}
    ok, failed, _ = harness.judge(readings, {"decode_gap_mean": 0.6}, 0, True)
    assert ok and failed == 0
    ok, failed, check = harness.judge(readings, {"decode_gap_mean": 0.085},
                                      0, True)
    assert not ok and failed == 1
    assert check == {"decode_gap_mean": {"value": 0.5, "limit": 0.085}}
