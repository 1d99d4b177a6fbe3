"""Build the native decode core: ``python -m bvc_tpu_torch.native.build``.

Compiles ``decode.cpp`` with ``g++`` and libjpeg into
``bvc_tpu_torch/_build/libbvc_native-<hash>.so`` (gitignored, beside the
CUDA kernels' libraries), keyed by a hash of the source and the flags so an
edited source builds anew.  The wrapper (:mod:`bvc_tpu_torch.native`)
builds at first use and falls back to the Python decode path when the
build fails (no compiler, no libjpeg).
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE.parent / "_build"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-ljpeg", "-pthread")


def library_path() -> Path:
    src = (HERE / "decode.cpp").read_bytes()
    digest = hashlib.sha256(src + " ".join(FLAGS + LIBS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libbvc_native-{digest}.so"


def build(verbose: bool = True) -> Path:
    """Compile unless the current library exists; the library appears under
    its final name only once complete, so concurrent builds are safe."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, str(HERE / "decode.cpp"), "-o", str(tmp), *LIBS]
    if verbose:
        print(" ".join(cmd))
    subprocess.run(cmd, check=True, capture_output=not verbose)
    os.replace(tmp, out)
    return out


if __name__ == "__main__":
    print(f"built {build()}")
    sys.exit(0)
