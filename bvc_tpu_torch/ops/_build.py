"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into
``_build/lib<name>-<hash>.so``, a library with a plain C interface that the
kernel wrappers load with :mod:`ctypes`.  The hash covers the source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source or
header builds anew and an unchanged one is reused.
``_build/`` is listed in ``.gitignore``: a fresh checkout builds from its own
sources and nothing else.  ``ptxas -v`` output (registers, shared memory,
spills) is kept beside each library as ``.log``.

Each kernel module types its own entry points (:func:`load_library` with
its signature table), brings its tensors into a layout the kernels read
(:func:`kernel_layout`) and calls them through :func:`launch`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``; raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels of bvc_tpu_torch "
                       "build on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: list[str]) -> dict[str, Path]:
    """Compile every source in ``names`` that has no current library, one
    ``nvcc`` process per source, all started together; raises with the
    compiler's output if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in names}
    procs = {}
    for name, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        paths[name].with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def build_log(name: str) -> str:
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load_library(name: str, signatures: dict[str, tuple[int, ...]]) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed, load it, and type each entry
    point of ``signatures`` (``{fn_name: (pointers, longs[, doubles])}``):
    ``pointers`` arguments as ``void*``, then ``longs`` as ``long long``,
    then ``doubles`` (none if not given) as ``double``, then the stream as
    ``void*``; every entry point returns its ``cudaError_t`` as an int."""
    lib = ctypes.CDLL(str(build_all([name])[name]))
    for fn_name, (pointers, longs, *doubles) in signatures.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_longlong] * longs
                       + [ctypes.c_double] * sum(doubles) + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def launch(caller: str, device: torch.device, fn, *args) -> None:
    """Call a kernel's C entry point with ``args`` and the current stream of
    ``device``; raise if the launch failed."""
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{caller}: kernel launch failed with CUDA error {rc}")


def kernel_layout(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the kernels read it, through its strides: unchanged where the
    last dimension is contiguous and every row starts on 16 bytes (so the
    strided q/k/v slices of a fused qkv tensor go in without a copy), else
    copied into a fresh (aligned) contiguous tensor; ``contiguous()`` alone
    would keep a contiguous view that starts off the 16-byte grid."""
    aligned = (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
               and all(s * x.element_size() % 16 == 0 for s in x.stride()[:-1]))
    return x if aligned else x.clone(memory_format=torch.contiguous_format)
