"""On the card: short runs of each committed cell through the benchmark's
command, the result line whole, and the same with ``--control``, whose
float8 control has to come out not correct under the cell's committed
limits while the program comes out correct.  Skips without a CUDA card."""

import json
import subprocess
import sys

import pytest

from perfbench.tests import smoke

WORKLOADS = [w["name"] for w in json.loads(
    (smoke.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _run(workload, seed, *extra):
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          workload, "--seed", str(seed), "--seconds", "8",
                          "--trace", "0", *extra],
                         capture_output=True, text=True, timeout=900,
                         cwd=smoke.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
def test_cell_runs_on_the_card(card):
    line = _run("rwkv6-longgen", 2 ** 31 + 3)
    assert list(line)[-1] == "check"
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert {"out_tok_s", "setup_s"} <= set(line["metrics"])


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_is_not_correct_on_the_card(card, workload):
    line = _run(workload, 2 ** 31 + 11, "--control")
    limits = json.loads((smoke.ROOT / "perfbench" / "limits" /
                         f"{workload}.json").read_text())
    assert line["correct"], line["check"]
    assert line["control"]["correct"] is False, line["control"]["check"]
    assert {k: v["limit"] for k, v in line["control"]["check"].items()} \
        == limits
