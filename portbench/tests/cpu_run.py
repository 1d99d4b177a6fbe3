"""One run of a cell on the CPU, in this process: what ``portbench.run``
does after its look for a card."""

from __future__ import annotations

import json
import tempfile
from pathlib import Path

import torch

from portbench import run as bench


def run_on_cpu(root: Path, cell: str, seed: int, trace: bool = False, fault=None,
               seconds: float = 0.2) -> dict:
    ctx = bench.Context(root, cell, seed, seconds, trace, torch.device("cpu"), fault=fault)
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        ctx.out_dir = Path(tmp)
        rec = bench.run_cell(ctx)
        return json.loads(json.dumps(bench.result_line(ctx, rec, [])))
