"""Build the native host libraries: ``python -m bvc_tpu_torch.native.build``.

Compiles with ``g++`` into ``bvc_tpu_torch/_build/lib<name>-<hash>.so``
(gitignored, beside the CUDA kernels' libraries), keyed by a hash of the
source and the flags so an edited source builds anew:

- ``bvc_native``: the decode core, ``decode.cpp`` with libjpeg.  Its wrapper
  (:mod:`bvc_tpu_torch.native`) builds at first use and falls back to the
  Python decode path when the build fails (no compiler, no libjpeg).
- ``bvc_sgd``: the linear probe's fit, ``sgd.cpp``, for
  :mod:`bvc_tpu_torch.evalbench.scores`.  No fallback: without it the probe
  raises.  No floating-point contraction, so its sums round as
  scikit-learn's do.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE.parent / "_build"
LIBRARIES = {
    "bvc_native": ("decode.cpp", ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"),
                   ("-ljpeg", "-pthread")),
    "bvc_sgd": ("sgd.cpp", ("-O2", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17"),
                ("-pthread",)),
}


def library_path(name: str = "bvc_native") -> Path:
    source, flags, libs = LIBRARIES[name]
    src = (HERE / source).read_bytes()
    digest = hashlib.sha256(src + " ".join(flags + libs).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(verbose: bool = True, name: str = "bvc_native") -> Path:
    """Compile unless the current library exists; the library appears under
    its final name only once complete, so concurrent builds are safe."""
    out = library_path(name)
    if out.exists():
        return out
    source, flags, libs = LIBRARIES[name]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *flags, str(HERE / source), "-o", str(tmp), *libs]
    if verbose:
        print(" ".join(cmd))
    subprocess.run(cmd, check=True, capture_output=not verbose)
    os.replace(tmp, out)
    return out


if __name__ == "__main__":
    for name in LIBRARIES:
        print(f"built {build(name=name)}")
    sys.exit(0)
