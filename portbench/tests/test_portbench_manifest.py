"""The harness is driven by data: a configuration, a cell and a per-layer
metric come in as new files and entries alone, and the harness finds,
validates and runs them by name; names and units are held to the allowed
characters."""

from __future__ import annotations

import copy
import hashlib
import json

import pytest

from portbench import manifest
from portbench.tests.conftest import REPO
from portbench.tests.cpu_run import run_on_cpu


def digests(root) -> dict[str, str]:
    base = root / "portbench"
    return {str(p.relative_to(base)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(base.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_the_repository_manifest_is_valid():
    manifest.validate(manifest.load(REPO), REPO)


def test_new_cells_configs_and_metrics_come_as_files_and_entries(root):
    """``tiny_root`` added two configurations and four cells; here one more
    per-layer metric is added, and none of the repository's files changed."""
    before = digests(REPO)
    copied = digests(root)
    assert all(copied[k] == v for k, v in before.items() if not k.startswith("tests"))
    (root / "portbench" / "metrics" / "calls_a_window.train.py").write_text(
        "def read(view):\n    return float(view.window['steps'])\n")
    m = manifest.load(root)
    m["per_layer"].append({"name": "calls_a_window.train", "unit": "calls", "better": "higher",
                           "source": "program_span", "layer": "Training steps",
                           "moves": "train_clips_per_s", "workloads": ["tiny.train"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    manifest.validate(manifest.load(root), root)
    line = run_on_cpu(root, "tiny.train", seed=17, trace=True, seconds=1.0)
    assert line["correct"]
    assert line["metrics"]["calls_a_window.train"]["value"] >= 1
    assert {"dispatch_ms.train", "train_mfu"} <= set(line["metrics"])
    assert digests(REPO) == before


@pytest.mark.parametrize("field,value", [
    ("name", "has space"), ("name", "a/b"), ("name", "x" * 65), ("name", "café"),
    ("unit", "tokens per second"), ("unit", "u" * 17), ("unit", "µs")])
def test_bad_names_and_units_are_refused(field, value):
    m = copy.deepcopy(manifest.load(REPO))
    m["end_to_end"][0][field] = value
    with pytest.raises(ValueError):
        manifest.validate(m, REPO)


@pytest.mark.parametrize("unit", ["clips/s", "%", "ms", "tokens/s", "GB.s-1", "u" * 16])
def test_units_of_the_allowed_characters_pass(unit):
    m = copy.deepcopy(manifest.load(REPO))
    m["end_to_end"][0]["unit"] = unit
    manifest.validate(m, REPO)


def test_a_cell_without_its_files_is_refused(root):
    m = manifest.load(root)
    m["workloads"].append({"name": "tiny.missing", "config": "tiny_videomae",
                           "traffic": "tiny.missing", "chips": 1, "why": "no file"})
    with pytest.raises(ValueError, match="no traffic file"):
        manifest.validate(m, root)
