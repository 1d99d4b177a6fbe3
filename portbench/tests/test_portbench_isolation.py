"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program.  Top-level module names are
compared whole: the port's name, ``bvc_tpu_torch``, begins with the JAX
package's, ``bvc_tpu``."""

from __future__ import annotations

import json
import subprocess
import sys

from portbench.tests.conftest import REPO

HARNESS = """
import json, sys
from pathlib import Path
sys.path.insert(0, {repo!r})
import portbench.run, portbench.controls.readings, portbench.faults, portbench.readers
import portbench.drivers.train, portbench.drivers.embed
from portbench import manifest
root = Path({repo!r})
for m in manifest.load(root)["per_layer"]:
    manifest.load_module(manifest.metric_path(root, m["name"]), "metric_" + m["name"])
import portbench.reference.videomae, portbench.reference.jepa, portbench.reference.train
import portbench.reference.compare
import bvc_tpu_torch.training.trainer_videomae, bvc_tpu_torch.training.trainer_jepa
import bvc_tpu_torch.evalbench.extract, bvc_tpu_torch.cli.pretrain_videomae
import bvc_tpu_torch.cli.pretrain_jepa
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {repo!r})
import portbench.reference.videomae, portbench.reference.jepa, portbench.reference.train
import portbench.reference.compare, portbench.reference.data, portbench.reference.masks
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code.format(repo=str(REPO))],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    names = top_level(HARNESS)
    assert "bvc_tpu_torch" in names and "portbench" in names
    assert not names & {"jax", "jaxlib", "flax", "bvc_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    names = top_level(REFERENCE)
    assert not names & {"jax", "jaxlib", "flax", "bvc_tpu", "bvc_tpu_torch"}
