"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``bvc_tpu_torch``.  The cell's
traffic (``portbench/workloads/<cell>.json``) names its window driver
(``portbench/drivers/<driver>.py``); the driver runs the program's own
entry over inputs and weights made from the seed, measures a window of
about ``--seconds``, and returns what it saw.  After the window the
reference (``portbench/reference/``) works the same answers out again from
the same inputs, and ``correct`` says whether every number compared is
within its limit.  ``--trace 1`` traces the window and reports the cell's
per-layer metrics (``portbench/metrics/<name>.py``) instead of its
end-to-end ones.

A cell on several cards starts one process a card: this process is rank 0,
and it starts ranks 1.. with ``--rank``; they meet over NCCL on
``localhost`` and report to rank 0 through files.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``compared``: each number compared with its limit.
The same numbers are the last lines of standard error.  Without CUDA, with
fewer cards than the cell asks for, or with JAX or the JAX package loaded
after the window, it prints no result and exits with another code than 0.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "bvc_tpu")  # top-level module names, whole


def process_start_epoch() -> float:
    """When this process started, seconds since the epoch (``/proc``)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
    return boot + ticks / os.sysconf("SC_CLK_TCK")


STARTED = process_start_epoch()


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def set_environment() -> None:
    """Caches of the program's libraries inside the checkout, at fixed paths;
    no library that would load JAX by itself does so."""
    cache = ROOT / "portbench" / "_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(cache / "inductor"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


class Context:
    """What a window driver and the metrics read of one run."""

    def __init__(self, root: Path, cell: str, seed: int, seconds: float, trace: bool,
                 device, rank: int = 0, world: int = 1, fault=None):
        from portbench import manifest

        self.root, self.cell, self.seed, self.seconds = Path(root), cell, seed, seconds
        self.trace, self.device, self.rank, self.world, self.fault = (
            trace, device, rank, world, fault)
        self.manifest = manifest.load(self.root)
        manifest.validate(self.manifest, self.root)
        self.workload = manifest.workload(self.manifest, cell)
        entry = manifest.config(self.manifest, self.workload["config"])
        self.config = json.loads((self.root / entry["file"]).read_text())
        self.traffic = json.loads(manifest.traffic_path(self.root, self.workload["traffic"])
                                  .read_text())
        self.corpus: dict | None = None
        self.shapes: dict | None = None
        self.out_dir: Path | None = None
        self.marks: list[tuple[str, float]] = [("start", STARTED)]

    def mark(self, what: str) -> None:
        """Note that set-up step ``what`` has ended (printed on standard
        error: where set-up goes)."""
        self.marks.append((what, time.time()))

    def setup_steps(self) -> str:
        return ", ".join(f"{b[0]} {b[1] - a[1]:.2f} s" for a, b in zip(self.marks, self.marks[1:]))

    def driver(self):
        import importlib

        return importlib.import_module(f"portbench.drivers.{self.traffic['driver']}")


# -- the reference ---------------------------------------------------------------
def reference_numbers(ctx: Context, rec: dict) -> dict[str, float]:
    """The numbers compared, worked out once the window has closed."""
    import importlib

    import torch

    from portbench import weights
    from portbench.reference import compare, vit

    fam = importlib.import_module(f"portbench.reference.{ctx.config['reference']}")
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    vit.tf32_off()
    try:
        params = weights.make_weights(ctx.shapes, ctx.seed, ctx.device)
        rows = ctx.traffic["reference_rows"]
        if ctx.traffic["driver"] == "embed":
            refs = []
            for clips in ctx.pool:
                x = torch.from_numpy(clips)
                refs.append(torch.cat([fam.embed(params, x[i:i + rows].to(ctx.device),
                                                 ctx.config["model"])
                                       for i in range(0, len(x), rows)]).cpu().numpy())
            return {"embed_cos_gap": max(compare.embed_cos_gap(out, refs[j])
                                     for j, out in rec["outputs"])}
        from portbench.reference.train import follow

        gb = ctx.traffic["batch_per_chip"] * ctx.world
        trainer = fam.Trainer(ctx.config, ctx.traffic, ctx.corpus, ctx.seed, ctx.device, gb)
        with torch.enable_grad():
            ref = follow(trainer, params, gb, ctx.traffic["checked_steps"], rows,
                         ctx.config["optim"])
        return compare.training_numbers(rec["readings"], ref)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


# -- several cards ---------------------------------------------------------------
def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> dict:
    return {"RANK": str(rank), "LOCAL_RANK": str(rank), "WORLD_SIZE": str(world),
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}


def _die_with_parent() -> None:
    """In a rank's process before it runs: end it when rank 0 ends."""
    import ctypes
    import signal

    ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG


def start_ranks(args, world: int, shared: Path) -> list[subprocess.Popen]:
    port = free_port()
    os.environ.update(rank_env(0, world, port))
    procs = []
    for r in range(1, world):
        log = open(shared / f"rank{r}.log", "w")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "portbench.run", "--workload", args.workload, "--seed",
             str(args.seed), "--seconds", str(args.seconds), "--trace", str(args.trace),
             "--rank", str(r), "--shared", str(shared), "--device", args.device,
             "--root", args.root, "--fault", args.fault],
            cwd=ROOT, env={**os.environ, **rank_env(r, world, port)}, stdout=log,
            stderr=subprocess.STDOUT, preexec_fn=_die_with_parent))
        log.close()
    return procs


def watch_ranks(procs: list[subprocess.Popen], shared: Path):
    """A thread that ends this run when another rank fails before its
    report (rank 0 would wait for it in a collective, with no end): prints
    that rank's log and exits.  Returns the event that stops the watch."""
    import threading

    done = threading.Event()

    def watch() -> None:
        while not done.wait(1.0):
            for r, p in enumerate(procs, start=1):
                if p.poll() not in (None, 0):
                    print(f"rank {r} ended with {p.returncode} during the run:\n"
                          f"{(shared / f'rank{r}.log').read_text()[-3000:]}", file=sys.stderr)
                    sys.stderr.flush()
                    for q in procs:
                        q.kill()
                    os._exit(1)

    threading.Thread(target=watch, daemon=True).start()
    return done


def wait_ranks(procs: list[subprocess.Popen], shared: Path, timeout: float = 180.0
               ) -> list[dict]:
    """The other ranks' reports; every rank has ended when this returns."""
    deadline = time.monotonic() + timeout
    out, failed = [], []
    try:
        for r, p in enumerate(procs, start=1):
            try:
                rc = p.wait(max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = None
            report = shared / f"rank{r}.json"
            if rc != 0 or not report.exists():
                failed.append(r)
                continue
            out.append(json.loads(report.read_text()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if failed:
        raise RuntimeError(f"ranks {failed} failed")  # main prints their logs
    return out


def wait_for(path: Path, timeout: float = 300.0) -> None:
    deadline = time.monotonic() + timeout
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} never came")
        time.sleep(0.05)


# -- one run -------------------------------------------------------------------
def run_cell(ctx: Context, shared: Path | None = None) -> dict:
    """Run the cell's driver on this rank; on rank 0 also the reference.
    Returns rank 0's record with ``numbers``."""
    import torch

    from portbench import corpus

    driver = ctx.driver()
    ctx.mark("imports")
    if ctx.traffic["driver"] == "train":
        spec = ctx.traffic["corpus"]
        if ctx.rank == 0:
            ctx.corpus = corpus.write_corpus(ctx.out_dir / "corpus", spec, ctx.seed, ctx.device)
            if shared is not None:
                (shared / "corpus.json").write_text(json.dumps(
                    {k: ctx.corpus[k] for k in ("jpg", "pack", "total")}))
        else:
            wait_for(shared / "corpus.json")
            ctx.corpus = json.loads((shared / "corpus.json").read_text())
        ctx.mark("corpus")
        if ctx.world > 1:
            cli = __import__(ctx.traffic["program"]["cli"], fromlist=["distributed_init"])
            cli.distributed_init(device=ctx.device)
            ctx.mark("process group")
    rec = driver.run(ctx)
    if ctx.rank == 0:
        t0 = time.perf_counter()
        rec["numbers"] = reference_numbers(ctx, rec)
        rec["reference_s"] = time.perf_counter() - t0
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return rec


def device_fields(ctx: Context, recs: list[dict]) -> dict:
    import torch

    out = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
           "kind": (torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda"
                    else "cpu"),
           "count": ctx.world,
           "memory_peak_bytes": max(int(r["memory_peak_bytes"]) for r in recs)}
    if ctx.trace:  # the device profile's, averaged over the cards
        traced = [(r["trace"].busy_us(), r["trace"].window_s) if r.get("trace") is not None
                  else (r["busy_us"], r["traced_s"]) for r in recs]
        out["busy_s"] = sum(b for b, _ in traced) / len(traced) * 1e-6
        out["window_s"] = sum(w for _, w in traced) / len(traced)
    try:
        out["power_limit_w"] = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
             "-i", str(ctx.device.index or 0)], capture_output=True, text=True, timeout=20
        ).stdout.split()[0])
    except (OSError, IndexError, ValueError, subprocess.TimeoutExpired):
        pass
    return out


class View:
    """What a per-layer metric's ``read(view)`` sees: the cell's
    configuration and traffic, rank 0's window record and trace, and the
    world."""

    def __init__(self, ctx: Context, rec: dict):
        self.config, self.traffic, self.world = ctx.config, ctx.traffic, ctx.world
        self.model = ctx.config["model"]
        self.window = rec
        self.trace = rec.get("trace")


def result_line(ctx: Context, rec: dict, others: list[dict]) -> dict:
    from portbench import manifest
    from portbench.reference import compare

    limits = ctx.traffic["limits"]
    correct, compared = compare.judged(rec["numbers"], limits)
    metrics = {}
    if not ctx.trace:
        for m in manifest.cell_metrics(ctx.manifest, ctx.cell, trace=False):
            if m["name"] == "setup_s":
                value = rec["open_epoch"] - STARTED
            elif m["name"] == ctx.traffic["rate_metric"]:
                value = rec["clips"] / rec["window_s"]
            else:
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        view = View(ctx, rec)
        for m in manifest.cell_metrics(ctx.manifest, ctx.cell, trace=True):
            reader = manifest.load_module(manifest.metric_path(ctx.root, m["name"]),
                                          "portbench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": correct, "attempted": rec["clips"], "failed": 0, "metrics": metrics,
            "device": device_fields(ctx, [rec] + others)}
    if ctx.trace and rec.get("trace") is not None:
        line["breakdown"] = {"device_ops": rec["trace"].top_ops(10),
                             "idle_gaps": rec["trace"].idle_gaps(10)}
    line["compared"] = {name: {"value": v, "limit": lim} for name, v, lim in compared}
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--shared", default="", help=argparse.SUPPRESS)
    p.add_argument("--device", default="cuda", help=argparse.SUPPRESS)  # "cpu": CPU tests
    p.add_argument("--root", default=str(ROOT), help=argparse.SUPPRESS)  # a test's manifest
    p.add_argument("--fault", default="", help=argparse.SUPPRESS)  # portbench/faults.py
    args = p.parse_args(argv)
    root = Path(args.root)
    set_environment()

    import torch

    from portbench import manifest

    chips = manifest.workload(manifest.load(root), args.workload)["chips"]
    if args.device == "cpu":
        device = torch.device("cpu")
    elif not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    else:
        device = torch.device("cuda", args.rank)
        torch.cuda.set_device(device)
    fault = None
    if args.fault:
        from portbench.faults import FAULTS

        fault = FAULTS[args.fault]()
    ctx = Context(root, args.workload, args.seed, args.seconds, bool(args.trace), device,
                  args.rank, chips, fault)
    base = Path(tempfile.gettempdir())
    if args.rank:  # a further rank of a multi-card cell
        shared = Path(args.shared)
        ctx.out_dir = shared / f"rank{args.rank}"
        rec = run_cell(ctx, shared)
        bad = forbidden_modules()
        trace = rec.get("trace")
        (shared / f"rank{args.rank}.json").write_text(json.dumps({
            "memory_peak_bytes": rec["memory_peak_bytes"],
            "busy_us": trace.busy_us() if trace is not None else 0.0,
            "traced_s": trace.window_s if trace is not None else 0.0, "forbidden": bad}))
        return 3 if bad else 0
    with tempfile.TemporaryDirectory(prefix="portbench-", dir=base) as tmp:
        ctx.out_dir = Path(tmp)
        shared, procs = None, []
        if chips > 1:
            shared = Path(tmp) / "ranks"
            shared.mkdir()
            procs = start_ranks(args, chips, shared)
            watching = watch_ranks(procs, shared)
        try:
            rec = run_cell(ctx, shared)
            if procs:
                watching.set()
            others = wait_ranks(procs, shared) if procs else []
        except Exception:
            for r in range(1, len(procs) + 1):
                log = shared / f"rank{r}.log"
                print(f"rank {r}'s log:\n{log.read_text()[-3000:]}", file=sys.stderr)
            raise
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                proc.wait()
        line = result_line(ctx, rec, others)
    bad = forbidden_modules() + [m for o in others for m in o["forbidden"]]
    if bad:
        print(f"loaded after the window: {sorted(set(bad))}", file=sys.stderr)
        return 3
    print(f"set-up: {ctx.setup_steps()}; reference {rec['reference_s']:.2f} s", file=sys.stderr)
    for name, row in line["compared"].items():
        print(f"compared {name} {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # the run failed: say why, print no result
        traceback.print_exc()
        sys.exit(1)
