"""The readings a cell's limits are set from, on the card, at the cell's size.

    python3 -m portbench.controls.readings --workload <cell> --seeds 11,12,... \
        [--control-seeds 21,22,23] [--faults half_batch] [--seconds 1]

In one process, for each of ``--seeds``: the cell's run as the benchmark
makes it (its window cut to ``--seconds``), the numbers compared, one JSON
line each (``kind: program``): the lower readings.  For each of
``--control-seeds``: the control, one JSON line each (``kind: control``):
for a training cell the reference put in the program's place in float8
(:class:`portbench.reference.vit.Precision`) against the f32 reference on
the same inputs; for extraction the program's own int8 path
(``quantize="int8"``) against the f32 reference.  For each fault of
``--faults`` (``portbench/faults.py``) and each control seed: the cell's
run with the fault planted (``kind: fault``).  Last, one line with the
largest program reading and the smallest control and fault readings of
each number.

A cell on several cards runs as the benchmark runs it, one process a card
(``--faults no_exchange`` for the gradient exchange left out); its control
is the reference's alone, on rank 0's card.
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from portbench import run as bench
from portbench import weights
from portbench.faults import FAULTS
from portbench.reference import compare, vit


def program_numbers(cell: str, seed: int, seconds: float, fault: str | None) -> dict:
    """One run of the cell; on several cards through the benchmark's own
    command (the ranks are processes), with the fault planted."""
    ctx = bench.Context(bench.ROOT, cell, seed, seconds, False, torch.device("cuda", 0),
                        fault=FAULTS[fault]() if fault else None)
    if ctx.workload["chips"] > 1:
        cmd = [sys.executable, "-m", "portbench.run", "--workload", cell, "--seed", str(seed),
               "--seconds", str(seconds), "--trace", "0"] + (["--fault", fault] if fault else [])
        out = subprocess.run(cmd, cwd=bench.ROOT, capture_output=True, text=True)
        if out.returncode:
            raise RuntimeError(out.stderr[-3000:])
        line = json.loads(out.stdout.strip().splitlines()[-1])
        return {k: v["value"] for k, v in line["compared"].items()}
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        ctx.out_dir = Path(tmp)
        return bench.run_cell(ctx)["numbers"]


def control_numbers(cell: str, seed: int) -> dict:
    """The control's numbers against the f32 reference."""
    from portbench import corpus as bench_corpus
    from portbench.reference.train import follow

    device = torch.device("cuda", 0)
    ctx = bench.Context(bench.ROOT, cell, seed, 1.0, False, device)
    vit.tf32_off()
    fam = importlib.import_module(f"portbench.reference.{ctx.config['reference']}")
    t, m = ctx.traffic, ctx.config["model"]
    if t["driver"] == "embed":
        from portbench.drivers.embed import make_pool, model_config

        extract = importlib.import_module(t["program"]["extract"])
        pool = make_pool(t, m, seed, device)
        # what untrained_embed_fn(quantize="int8") builds, with the benchmark's
        # weights loaded before the blocks are quantized
        model = extract.init_family_model(ctx.config["family"], model_config(ctx))
        params = weights.make_weights(weights.shapes_of(model), seed, device)
        model.load_state_dict({k: v.cpu() for k, v in params.items()})
        fn = extract._embed_fn(extract.quantize_encoder(model), device)
        gap = 0.0
        rows = t["reference_rows"]
        for clips in pool:
            x = torch.from_numpy(clips)
            ref = torch.cat([fam.embed(params, x[i:i + rows].to(device), m)
                             for i in range(0, len(x), rows)]).cpu().numpy()
            gap = max(gap, compare.embed_cos_gap(fn(clips), ref))
        return {"embed_cos_gap": gap}
    gb = t["batch_per_chip"] * ctx.workload["chips"]
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        corpus = bench_corpus.write_corpus(Path(tmp) / "corpus", t["corpus"], seed, device)
        shapes = _train_shapes(ctx)
        params = weights.make_weights(shapes, seed, device)
        runs = {}
        for kind in ("f32", "fp8"):
            trainer = fam.Trainer(ctx.config, t, corpus, seed, device, gb)
            with torch.enable_grad():
                runs[kind] = follow(trainer, params, gb, t["checked_steps"],
                                    t["reference_rows"], ctx.config["optim"],
                                    vit.Precision(kind))
    return compare.training_numbers(runs["fp8"], runs["f32"])


def _train_shapes(ctx) -> dict:
    from portbench.drivers.train import train_config

    trainer = importlib.import_module(ctx.traffic["program"]["trainer"])
    ctx.corpus = {"jpg": "", "pack": ""}
    ctx.out_dir = Path(tempfile.gettempdir())
    cfg = train_config(ctx)
    model = getattr(trainer, ctx.traffic["program"]["model_class"])(cfg.model, seed=0)
    return weights.shapes_of(model)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--no-control", action="store_true",
                   help="the control seeds serve the faults only (a multi-card cell's "
                        "control runs on one card, in its own call)")
    a = p.parse_args()
    bench.set_environment()
    seeds = [int(s) for s in a.seeds.split(",") if s]
    cseeds = [int(s) for s in a.control_seeds.split(",") if s]
    lines = []

    def emit(kind: str, seed: int, numbers: dict, fault: str | None = None) -> None:
        line = {"kind": kind, "seed": seed, "fault": fault, "numbers": numbers}
        lines.append(line)
        print(json.dumps(line), flush=True)

    for s in seeds:
        emit("program", s, program_numbers(a.workload, s, a.seconds, None))
    for s in [] if a.no_control else cseeds:
        emit("control", s, control_numbers(a.workload, s))
    for f in [f for f in a.faults.split(",") if f]:
        for s in cseeds:
            emit("fault", s, program_numbers(a.workload, s, a.seconds, f), f)
    summary: dict = {}
    for line in lines:
        for k, v in line["numbers"].items():
            row = summary.setdefault(k, {"program_max": None, "control_min": None,
                                         "fault_min": {}})
            if line["kind"] == "program":
                row["program_max"] = max(v, row["program_max"] or 0.0)
            elif line["kind"] == "control":
                row["control_min"] = v if row["control_min"] is None else min(v, row["control_min"])
            else:
                old = row["fault_min"].get(line["fault"])
                row["fault_min"][line["fault"]] = v if old is None else min(v, old)
    print(json.dumps({"summary": summary}), flush=True)


if __name__ == "__main__":
    main()
