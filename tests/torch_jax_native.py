"""The JAX package's native decode library, loaded steadily for the tests
that hold the port's decoded frames (or what is computed from them) against
that package's.

``bvc_tpu.native`` compiles its library with ``g++ -o`` straight onto the
final path, and rebuilds it whenever it is missing or older than
``decode.cpp``, as it is in a fresh checkout; other test workers
(``test_native.py``, ``test_evalbench.py``, the JAX data and curriculum
tests) may be writing it at this moment.  A load of the half-written file
fails, and the failure sticks (``_load_failed``) for the rest of the
process: from then on that package decodes every frame in Python, a
decode-then-resize that differs from the native DCT-scaled decode by up to
a grey level, while the port (which builds its own library atomically) goes
on decoding natively.  A JAX embedding of a resized frame then moves by
about 1e-3 of its size.
"""

from __future__ import annotations

import fcntl
import tempfile
import time
from pathlib import Path

from bvc_tpu import native as jax_native


def steady_jax_native(attempts: int = 40) -> bool:
    """``bvc_tpu.native.available()``, steady against another process that
    rebuilds the library: after a failed load, take a cross-process lock,
    wait until the file has stopped changing, reset the loader and load
    again, at most ``attempts`` times."""
    if jax_native.available():
        return True
    lib = jax_native._LIB_PATH
    with open(Path(tempfile.gettempdir()) / "bvc_native_test.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        for _ in range(attempts):
            seen = None
            for _ in range(100):  # until unchanged over 0.3 s, at most 30 s
                now = (lib.stat().st_size, lib.stat().st_mtime_ns) if lib.exists() else None
                if now is not None and now == seen:
                    break
                seen = now
                time.sleep(0.3)
            jax_native._lib, jax_native._load_failed = None, False
            if jax_native.available():
                return True
            time.sleep(0.5)
    return False
