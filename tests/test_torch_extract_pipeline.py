"""The extraction entry's chunk plan on the CPU: ``chunk_bounds`` (chunks of
whole clips from a batch's host bytes), the rows of a chunked call against
the whole batch's call and against each chunk's own call, outputs that do
not alias, the ``seq`` path's single chunk, and the counters.  The pinned
copies that a CUDA device runs the same plan through are checked on the
card (``chip_smoke.py`` phase 8)."""

import numpy as np
import pytest
import torch

from bvc_tpu_torch.evalbench import extract
from bvc_tpu_torch.models.videomae import VideoMAEEncoder
from bvc_tpu_torch.utils.config import ModelConfig

VIDEOMAE = dict(image_size=32, patch_size=8, num_frames=4, tubelet_size=2, hidden_size=32,
                depth=2, num_heads=4, mlp_ratio=2.0, decoder_hidden_size=16,
                decoder_depth=1, decoder_num_heads=2)
JEPA = dict(family="jepa", image_size=16, patch_size=8, num_frames=2, tubelet_size=1,
            hidden_size=32, depth=2, num_heads=4)
SIMCLR = dict(architecture="resnet18", image_size=32, num_frames=2)
CLIP = (4, 32, 32, 3)  # VIDEOMAE's clip
MIB = 1 << 20


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clips(n: int, shape=CLIP, seed: int = 0, dtype=np.uint8) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, *shape)).astype(dtype)


def _covers(bounds, batch: int) -> bool:
    return (bounds[0][0] == 0 and bounds[-1][1] == batch
            and all(e0 == s1 for (_, e0), (s1, _) in zip(bounds, bounds[1:]))
            and all(e > s for s, e in bounds if batch))


VIT_CLIP = (16, 224, 224, 3)  # the benchmark's VideoMAE-B clip
JEPA_CLIP = (2, 224, 224, 3)  # V-JEPA ViT-B's


@pytest.mark.parametrize("batch,clip_shape,dtype,sizes", [
    # the benchmark's batch, 154 MB of uint8, and the readers' float32 clips
    # of 616 MB: two chunks of 32 clips, the float32 ones not cut smaller
    (64, VIT_CLIP, np.uint8, [32, 32]),
    (64, VIT_CLIP, np.float32, [32, 32]),
    (128, VIT_CLIP, np.uint8, [32] * 4),
    (96, VIT_CLIP, np.uint8, [32] * 3),
    (256, VIT_CLIP, np.float32, [32] * 8),
    # under two chunks' worth of clips or of bytes: one chunk
    (63, VIT_CLIP, np.float32, [63]),
    (64, JEPA_CLIP, np.uint8, [64]),
    (64, JEPA_CLIP, np.float32, [64]),
    (1, VIT_CLIP, np.float32, [1]),
    (0, VIT_CLIP, np.uint8, [0]),
    # bytes to spare: the clips bound the count, near-equal chunks
    (100, (40 * MIB,), np.uint8, [33, 33, 34]),
    # clips to spare: the bytes bound it
    (200, (MIB,), np.uint8, [40] * 5),
])
def test_chunk_bounds_from_shape_and_dtype(batch, clip_shape, dtype, sizes):
    nbytes = batch * int(np.prod(clip_shape)) * np.dtype(dtype).itemsize
    bounds = extract.chunk_bounds(batch, nbytes)
    assert [e - s for s, e in bounds] == sizes
    assert _covers(bounds, batch)


def _target(monkeypatch, clips: int, nbytes: int) -> None:
    monkeypatch.setattr(extract, "CHUNK_CLIPS", clips)
    monkeypatch.setattr(extract, "CHUNK_BYTES", nbytes)


def test_chunk_bounds_follow_the_targets(monkeypatch):
    """Whole clips only, near-equal, as many as both targets allow."""
    for least in (1, 2, 5):
        _target(monkeypatch, least, 100)
        for batch in range(1, 40):
            for nbytes in (batch * 7, batch * 30, batch * 100, batch * 333):
                bounds = extract.chunk_bounds(batch, nbytes)
                assert len(bounds) == max(1, min(batch // least, nbytes // 100))
                assert _covers(bounds, batch)
                sizes = [e - s for s, e in bounds]
                assert max(sizes) - min(sizes) <= 1
                assert len(bounds) == 1 or min(sizes) >= least


def _embed_fn(family: str, dtype: str, quantize: str = "none"):
    kw = {"videomae": VIDEOMAE, "jepa": JEPA, "simclr": SIMCLR}[family]
    cfg = ModelConfig(**kw, **({} if family == "simclr" else {"dtype": dtype}))
    return extract.untrained_embed_fn(family, cfg, seed=1, device="cpu", quantize=quantize)


def _clip_of(fn) -> tuple:
    cfg = fn.model.cfg if hasattr(fn.model, "cfg") else None
    if cfg is None:  # the ResNet
        return (SIMCLR["num_frames"], SIMCLR["image_size"], SIMCLR["image_size"], 3)
    return (cfg.num_frames, cfg.image_size, cfg.image_size, 3)


@pytest.mark.parametrize("family,dtype,quantize", [
    ("videomae", "bfloat16", "none"),
    ("videomae", "bfloat16", "int8"),
    ("videomae", "float32", "none"),
    ("jepa", "bfloat16", "none"),
    ("simclr", "float32", "none"),
])
def test_chunked_rows_match_the_whole_batch_and_each_chunk(family, dtype, quantize,
                                                           monkeypatch):
    """Seven clips at a target of two clips' bytes run as chunks of 2, 2 and
    3: the rows in order, bit for bit each chunk's own call, and within f32
    rounding of the batch run as one chunk (the int8 path's activation
    scale is a token's own)."""
    fn = _embed_fn(family, dtype, quantize)
    clips = _clips(7, _clip_of(fn), seed=2)
    clip_bytes = clips[:1, -1:].nbytes if family == "simclr" else clips[:1].nbytes
    _target(monkeypatch, 2, 2 * clip_bytes)
    bounds = extract.chunk_bounds(7, 7 * clip_bytes)
    assert bounds == [(0, 2), (2, 4), (4, 7)]
    chunked = fn(clips)
    assert (fn.chunks, fn.calls_chunked) == (3, 1)
    alone = np.concatenate([fn(clips[s:e]) for s, e in bounds])
    assert (fn.chunks, fn.calls_chunked) == (6, 1)
    _target(monkeypatch, 2, 1 << 40)
    whole = fn(clips)
    assert (fn.chunks, fn.calls_chunked) == (7, 1)
    assert chunked.shape == (7, fn.feature_dim) and chunked.dtype == np.float32
    np.testing.assert_array_equal(chunked, alone)
    np.testing.assert_allclose(chunked, whole, rtol=1e-5, atol=1e-5)


def test_float32_clips_chunk_by_their_own_bytes(monkeypatch):
    """Float32 clips (the readers') hold four times the bytes of uint8 ones
    of their shape: four times the chunks where the bytes bound them, their
    rows those of the batch run as one chunk."""
    fn = _embed_fn("videomae", "float32")
    clips = _clips(8, seed=3)
    _target(monkeypatch, 1, 2 * clips[:1].nbytes)
    fn(clips)
    assert (fn.chunks, fn.calls_chunked) == (4, 1)
    normed = (clips / 255.0).astype(np.float32)
    chunked = fn(normed)
    assert (fn.chunks, fn.calls_chunked) == (12, 2)
    _target(monkeypatch, 1, 1 << 40)
    np.testing.assert_allclose(chunked, fn(normed), rtol=1e-5, atol=1e-5)


def test_outputs_of_two_calls_do_not_alias(monkeypatch):
    fn = _embed_fn("videomae", "bfloat16")
    a, b = _clips(6, seed=4), _clips(6, seed=5)
    _target(monkeypatch, 2, 2 * a[:1].nbytes)
    first = fn(a)
    kept = first.copy()
    second = fn(b)
    assert fn.calls_chunked == 2
    np.testing.assert_array_equal(first, kept)
    assert not np.shares_memory(first, second)
    assert not np.array_equal(first, second)
    np.testing.assert_array_equal(fn(a), kept)


def test_the_seq_path_runs_one_chunk(monkeypatch):
    """A ``seq`` rank's call is one forward whatever its bytes (the ring's
    collective runs inside it, and ranks' batches may differ in size), on a
    one-process mesh here."""
    model = VideoMAEEncoder(ModelConfig(**VIDEOMAE), seed=1)
    fn = extract._embed_fn(model, torch.device("cpu"), seq=True)
    clips = _clips(5, seed=6)
    _target(monkeypatch, 1, clips[:1].nbytes)
    out = [fn(clips), fn(clips[:1]), fn(clips[:3])]
    assert [o.shape for o in out] == [(5, 32), (1, 32), (3, 32)]
    assert (fn.chunks, fn.calls_chunked) == (3, 0)
    np.testing.assert_allclose(out[2], out[0][:3], rtol=1e-5, atol=1e-5)


def test_counters_count_as_planned(monkeypatch):
    """Chunks run and calls of more than one, over calls of 7, 1, 2 and 4
    clips and a one-clip float32 dummy batch, at targets of two clips and
    two uint8 clips' bytes."""
    fn = _embed_fn("videomae", "float32")
    _target(monkeypatch, 2, 2 * _clips(1).nbytes)
    assert (fn.chunks, fn.calls_chunked) == (0, 0)
    planned = []
    for clips in (_clips(7), _clips(1), _clips(2), _clips(4),
                  np.zeros((1, *CLIP), np.float32)):
        planned.append(len(extract.chunk_bounds(len(clips), clips.nbytes)))
        out = fn(clips)
        assert out.shape == (len(clips), 32)
    assert planned == [3, 1, 1, 2, 1]
    assert (fn.chunks, fn.calls_chunked) == (8, 2)
