"""``BENCHMARK.json`` and the files it names, found by name.

- a configuration ``c``: ``portbench/configs/<c>.json`` (its ``file``);
- a cell ``w``: ``portbench/workloads/<w>.json``, its traffic, which names
  its window driver ``d``: ``portbench/drivers/<d>.py``;
- a per-layer metric ``m``: ``portbench/metrics/<m>.py``, a module with
  ``read(view) -> float | None``.

A later change adds a configuration, a cell or a metric by adding its files
and its entry; :func:`validate` checks the whole manifest, names and units
by the allowed characters included.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}


def load(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def workload(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(manifest: dict, name: str) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


def traffic_path(root: Path, name: str) -> Path:
    return Path(root) / "portbench" / "workloads" / f"{name}.json"


def metric_path(root: Path, name: str) -> Path:
    return Path(root) / "portbench" / "metrics" / f"{name}.py"


def driver_path(root: Path, name: str) -> Path:
    return Path(root) / "portbench" / "drivers" / f"{name}.py"


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_metrics(manifest: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (``trace`` False) or per-layer ones."""
    return [m for m in manifest["per_layer" if trace else "end_to_end"] if applies(m, cell)]


def validate(manifest: dict, root: Path) -> None:
    """Raise ``ValueError`` naming every breach of the manifest's rules that
    a file of the repository can show."""
    root = Path(root)
    bad: list[str] = []

    def name_ok(what: str, s) -> None:
        if not isinstance(s, str) or not NAME.match(s):
            bad.append(f"{what}: {s!r} is not a name")

    def line_ok(what: str, s) -> None:
        if not isinstance(s, str) or not 1 <= len(s) <= 200 or "\n" in s or "\t" in s:
            bad.append(f"{what}: not one line of 1-200 characters")

    want = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    if set(manifest) != want:
        bad.append(f"keys {sorted(manifest)}, want {sorted(want)}")
    configs = {c.get("name") for c in manifest.get("configs", [])}
    e2e = {m.get("name") for m in manifest.get("end_to_end", [])}
    for c in manifest.get("configs", []):
        name_ok("config", c.get("name"))
        line_ok(f"config {c.get('name')} source", c.get("source"))
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            bad.append(f"config {c.get('name')}: keys {sorted(c)}")
        if not (root / c.get("file", "")).is_file():
            bad.append(f"config {c.get('name')}: no file {c.get('file')}")
        for k in c.get("reduced", []):
            name_ok(f"config {c.get('name')} reduced", k)
    cells = set()
    for w in manifest.get("workloads", []):
        name_ok("workload", w.get("name"))
        name_ok(f"workload {w.get('name')} traffic", w.get("traffic"))
        line_ok(f"workload {w.get('name')} why", w.get("why"))
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            bad.append(f"workload {w.get('name')}: keys {sorted(w)}")
        if w.get("config") not in configs:
            bad.append(f"workload {w.get('name')}: unknown config {w.get('config')!r}")
        if w.get("chips") not in (1, 4):
            bad.append(f"workload {w.get('name')}: chips {w.get('chips')}")
        if w.get("name") in cells:
            bad.append(f"workload {w.get('name')}: named twice")
        cells.add(w.get("name"))
        if not traffic_path(root, w.get("traffic", "")).is_file():
            bad.append(f"workload {w.get('name')}: no traffic file")
        else:
            driver = json.loads(traffic_path(root, w["traffic"]).read_text()).get("driver", "")
            if not driver_path(root, driver).is_file():
                bad.append(f"workload {w.get('name')}: no driver {driver!r}")
    names = set()
    for kind in ("end_to_end", "per_layer"):
        for m in manifest.get(kind, []):
            name_ok(kind, m.get("name"))
            if m.get("name") in names:
                bad.append(f"metric {m.get('name')}: named twice")
            names.add(m.get("name"))
            if not isinstance(m.get("unit"), str) or not UNIT.match(m["unit"]):
                bad.append(f"metric {m.get('name')}: unit {m.get('unit')!r}")
            if m.get("better") not in ("lower", "higher"):
                bad.append(f"metric {m.get('name')}: better {m.get('better')!r}")
            if m.get("source") not in (SOURCES_E2E if kind == "end_to_end" else SOURCES):
                bad.append(f"metric {m.get('name')}: source {m.get('source')!r}")
            for c in m.get("workloads", []):
                if c not in cells:
                    bad.append(f"metric {m.get('name')}: unknown cell {c!r}")
            if kind == "per_layer":
                line_ok(f"metric {m.get('name')} layer", m.get("layer"))
                if m.get("moves") not in e2e:
                    bad.append(f"metric {m.get('name')}: moves {m.get('moves')!r}")
                if not metric_path(root, m.get("name", "")).is_file():
                    bad.append(f"metric {m.get('name')}: no reader file")
                for c in m.get("workloads", sorted(cells)):
                    moved = next((e for e in manifest["end_to_end"]
                                  if e["name"] == m.get("moves")), {})
                    if not applies(moved, c):
                        bad.append(f"metric {m.get('name')}: cell {c} lacks {m.get('moves')}")
            elif not isinstance(m.get("bound"), (int, float)) or not 0 < m["bound"] <= 0.25:
                bad.append(f"metric {m.get('name')}: bound {m.get('bound')!r}")
    if "setup_s" not in e2e:
        bad.append("no setup_s")
    for c in cells:
        if not any(applies(m, c) for m in manifest.get("per_layer", [])):
            bad.append(f"workload {c}: no per-layer metric")
    if bad:
        raise ValueError("BENCHMARK.json: " + "; ".join(bad))
