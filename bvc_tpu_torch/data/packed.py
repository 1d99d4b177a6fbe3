"""Packed-corpus ingestion: pre-resized uint8 frame shards (a copy of
:mod:`bvc_tpu.data.packed`, the same on-disk format).

The reference's true input bottleneck is per-step JPEG decode of
640x480 stills (SURVEY.md §2.11 "libjpeg decode";
``generative/homeview.py:272-274`` decodes inside ``__getitem__``).  The
round-4 measurement on this box: 8.2 clips/s end-to-end on 1 core
decode-bound vs 240 clips/s step-only (PERFORMANCE.md).  Packing runs
the decode+resize ONCE offline and the training loop then memmap-reads
pre-cropped ``[S, S, 3]`` uint8 frames — ~2.4 MB/clip of sequential
reads instead of ~16 full JPEG decodes.

Format (one shard per subject dir, index-compatible with the
``get_fpathlist``/``get_fpathseqlist`` path semantics — frames are keyed
by their original basename, so every existing sampler works unchanged):

- ``<pack_root>/<subject>/frames_<S>.u8``  — ``[n, S, S, 3]`` uint8
  memmap, rows in ``get_fpathlist`` order (sorted basenames, ds_rate 1 —
  pack ALL frames so any loader ds_rate finds its subset).
- ``<pack_root>/<subject>/frames_<S>.json`` — ``{"image_size", "dct_scale",
  "names": [...basenames...]}``.

The packed pixels are produced by the SAME plain decode stack the loader
would run (native fused decode when available, else
``center_crop(resize_shorter(...))``), so a packed read is bit-identical
to the decode path it replaces (tests/test_packed.py).  Augmented
transforms (any of 'cjbgo') need the full-resolution source and bypass
the reader automatically.  :func:`write_shard` writes a shard from frames
already in memory (synthetic corpora on a machine without a JPEG decoder).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def _plain_decode(paths: list[str], image_size: int, dct_scale: bool) -> np.ndarray:
    """The loader's plain path: fused native decode when available, else
    the python resize->center-crop stack (decode parity is with whichever
    the loader itself would take)."""
    from bvc_tpu_torch import native

    if native.available():
        return native.decode_frames(paths, image_size, uint8=True,
                                    dct_scale=dct_scale)
    from bvc_tpu_torch.data.transforms import center_crop, decode_jpeg, resize_shorter

    return np.stack([
        center_crop(resize_shorter(decode_jpeg(p), image_size), image_size)
        for p in paths
    ])


def pack_subject(jpg_root: str, subject: str, pack_root: str,
                 image_size: int = 224, dct_scale: bool = True,
                 chunk: int = 256) -> int:
    """Pack one subject dir; returns the number of frames written.
    Idempotent: an existing shard with a matching index is left alone."""
    from bvc_tpu_torch.data.indexing import get_fpathlist

    fps = get_fpathlist(jpg_root, subject, ds_rate=1)
    out_dir = Path(pack_root) / subject
    shard = out_dir / f"frames_{image_size}.u8"
    index = out_dir / f"frames_{image_size}.json"
    names = [Path(p).name for p in fps]
    if index.exists():
        meta = json.loads(index.read_text())
        if meta.get("names") == names and meta.get("dct_scale") == dct_scale \
                and shard.exists():
            return len(names)
    chunks = (_plain_decode(fps[lo:lo + chunk], image_size, dct_scale)
              for lo in range(0, len(fps), chunk))
    return write_shard(pack_root, subject, names, chunks, image_size, dct_scale)


def write_shard(pack_root: str, subject: str, names: list[str], chunks,
                image_size: int = 224, dct_scale: bool = True) -> int:
    """Write ``<pack_root>/<subject>/frames_<S>.{u8,json}`` from ``chunks``,
    uint8 ``[k, S, S, 3]`` arrays whose rows follow ``names`` (sorted frame
    basenames); returns the number of frames written."""
    out_dir = Path(pack_root) / subject
    out_dir.mkdir(parents=True, exist_ok=True)
    shard = out_dir / f"frames_{image_size}.u8"
    index = out_dir / f"frames_{image_size}.json"
    arr = np.memmap(shard, dtype=np.uint8, mode="w+",
                    shape=(len(names), image_size, image_size, 3))
    lo = 0
    for frames in chunks:
        arr[lo:lo + len(frames)] = frames
        lo += len(frames)
    if lo != len(names):
        raise ValueError(f"{lo} frames written for {len(names)} names")
    arr.flush()
    del arr
    # index written LAST: a crash mid-pack leaves no index, so the reader
    # never sees a half-written shard
    index.write_text(json.dumps({
        "image_size": image_size, "dct_scale": dct_scale, "names": names,
    }))
    return len(names)


def pack_corpus(jpg_root: str, pack_root: str, image_size: int = 224,
                subjects: list[str] | None = None,
                dct_scale: bool = True) -> dict[str, int]:
    """Pack every subject dir under ``jpg_root`` (or the given subset)."""
    root = Path(jpg_root)
    if subjects is None:
        subjects = sorted(p.name for p in root.iterdir() if p.is_dir())
    return {
        s: pack_subject(jpg_root, s, pack_root, image_size, dct_scale)
        for s in subjects
    }


class PackedCorpus:
    """Memmap-backed frame reader keyed by original jpg path.

    ``get(fp)`` maps ``<anything>/<subject>/<name>.jpg`` to its packed
    row (uint8 ``[S, S, 3]``) or returns None when the subject/frame is
    not packed at this (image_size, dct_scale) — callers fall back to
    the decode path, so a partially packed corpus still works.
    """

    def __init__(self, pack_root: str, image_size: int,
                 dct_scale: bool = True):
        self.root = Path(pack_root)
        self.image_size = image_size
        self.dct_scale = dct_scale
        # subject -> (memmap, {basename: row}) | None (known-unpacked)
        self._shards: dict[str, tuple[np.memmap, dict[str, int]] | None] = {}

    def _shard(self, subject: str):
        if subject not in self._shards:
            index = self.root / subject / f"frames_{self.image_size}.json"
            shard = self.root / subject / f"frames_{self.image_size}.u8"
            if not (index.exists() and shard.exists()):
                self._shards[subject] = None
            else:
                meta = json.loads(index.read_text())
                if meta.get("dct_scale") != self.dct_scale:
                    self._shards[subject] = None
                else:
                    arr = np.memmap(
                        shard, dtype=np.uint8, mode="r",
                        shape=(len(meta["names"]), self.image_size,
                               self.image_size, 3))
                    rows = {n: i for i, n in enumerate(meta["names"])}
                    self._shards[subject] = (arr, rows)
        return self._shards[subject]

    def get(self, fp: str) -> np.ndarray | None:
        p = Path(fp)
        hit = self._shard(p.parent.name)
        if hit is None:
            return None
        arr, rows = hit
        i = rows.get(p.name)
        if i is None:
            return None
        # np.asarray detaches from the memmap (workers may outlive it)
        return np.asarray(arr[i])

    def get_seq(self, fps) -> np.ndarray | None:
        """All-or-nothing sequence read (mixed packed/unpacked clips take
        the decode path wholesale — simpler and the miss case is rare).

        Unlike the JAX package's per-frame read, the frames come out in one
        gather a shard, into one clip array (a clip's window over the fold's
        frame list crosses into the next subject at its end).  Sixteen
        memmap reads and a stack a clip held the interpreter lock long
        enough, across the loader's threads, to slow a GPU trainer's kernel
        dispatch."""
        runs: list[tuple[np.memmap, list[int]]] = []  # consecutive frames of one shard
        for fp in fps:
            p = Path(fp)
            hit = self._shard(p.parent.name)
            i = None if hit is None else hit[1].get(p.name)
            if i is None:
                return None
            if not runs or runs[-1][0] is not hit[0]:
                runs.append((hit[0], []))
            runs[-1][1].append(i)
        S = self.image_size
        out = np.empty((sum(len(rows) for _, rows in runs), S, S, 3), np.uint8)
        at = 0
        for shard, rows in runs:
            np.take(shard, rows, axis=0, out=out[at:at + len(rows)])
            at += len(rows)
        return out
