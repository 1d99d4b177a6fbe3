"""Runs with the timed path broken underneath come out not correct: the
harness's look for a card skipped, everything else as a run drives it."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench.faults import FAULTS
from portbench.tests.conftest import REPO
from portbench.tests.cpu_run import run_on_cpu


@pytest.mark.parametrize("cell,fault", [("tiny.train", "unchanged"),
                                        ("tiny.train", "half_batch"),
                                        ("tiny_jepa.train", "unchanged"),
                                        ("tiny_jepa.train", "half_batch"),
                                        ("tiny.embed", "altered")])
def test_a_broken_step_is_not_correct(root, cell, fault):
    line = run_on_cpu(root, cell, seed=2**32 + 3, fault=FAULTS[fault]())
    assert not line["correct"], line["compared"]


def four_ranks(root, seed: int, fault: str = "") -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "tiny.train.ddp4", "--seed",
         str(seed), "--seconds", "0.3", "--trace", "0", "--device", "cpu", "--root", str(root)]
        + (["--fault", fault] if fault else []),
        cwd=REPO, capture_output=True, text=True, timeout=600)


def test_four_ranks_and_the_exchange_left_out(root):
    """The data-parallel cell on four gloo processes: correct as it runs, not
    correct with the gradient exchange between the ranks left out."""
    good = four_ranks(root, 2**31 + 99)
    assert good.returncode == 0, good.stderr[-3000:]
    assert json.loads(good.stdout.strip().splitlines()[-1])["correct"]
    bad = four_ranks(root, 2**31 + 99, "no_exchange")
    assert bad.returncode == 0, bad.stderr[-3000:]
    line = json.loads(bad.stdout.strip().splitlines()[-1])
    assert not line["correct"], line["compared"]


def test_a_rank_that_fails_ends_the_run(root):
    """A further rank that dies mid-run ends the run with its log, where
    rank 0 would otherwise wait for it in a collective."""
    out = four_ranks(root, 2**31 + 5, "dead_rank")
    assert out.returncode != 0
    assert "a rank failed" in out.stderr
    assert not out.stdout.strip().endswith("}")
