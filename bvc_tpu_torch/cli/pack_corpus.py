"""Pack a jpg frame corpus into pre-resized uint8 memmap shards
(counterpart of :mod:`bvc_tpu.cli.pack_corpus`, the same flags).

Offline companion to ``--pack_root`` on the pretrain CLIs and
``run_curriculum``: runs the plain decode+resize stack once per frame and
writes per-subject ``frames_<S>.u8`` shards (bvc_tpu_torch/data/packed.py),
so the training hot loop reads bytes instead of decoding 640x480 JPEGs
(the reference decodes inside ``__getitem__`` every epoch —
``generative/homeview.py:272-274``).  Runs on the host; no GPU is needed.

Usage::

    python -m bvc_tpu_torch.cli.pack_corpus -jpg_root /data/homeview \
        -pack_root /fast/packed --image_size 224 [--group g0] \
        [--strict_resample]
"""

from __future__ import annotations

import argparse
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-jpg_root", type=str, required=True)
    p.add_argument("-pack_root", type=str, required=True)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--group", type=str, default="",
                   help="pack only this age group's subject dirs "
                        "(g0|g1|g2|g3|gr); default: every dir present")
    p.add_argument("--strict_resample", action="store_true",
                   help="decode at full DCT scale (pixel parity with the "
                        "cv2 decode-then-resize path; slower). Default "
                        "matches the loader's native fast path.")
    return p


def main(argv=None) -> dict[str, int]:
    """Pack, print the frame count and rate, and return the frames packed
    per subject."""
    args = build_parser().parse_args(argv)
    from bvc_tpu_torch.data.packed import pack_corpus

    subjects = None
    if args.group:
        from pathlib import Path

        from bvc_tpu_torch.data.indexing import get_group

        group = get_group(args.group)
        if group is None:
            raise SystemExit(f"unknown group {args.group!r}")
        subjects = [s for s in group
                    if (Path(args.jpg_root) / s).is_dir()]
    t0 = time.perf_counter()
    counts = pack_corpus(args.jpg_root, args.pack_root, args.image_size,
                         subjects=subjects,
                         dct_scale=not args.strict_resample)
    dt = time.perf_counter() - t0
    total = sum(counts.values())
    print(f"packed {total} frames across {len(counts)} subjects "
          f"in {dt:.1f}s ({total / max(dt, 1e-9):.0f} frames/s)")
    return counts


if __name__ == "__main__":
    main()
