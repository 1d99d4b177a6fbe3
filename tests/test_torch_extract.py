"""The port's extraction entry point: a ``.pth.tar`` written from JAX params
in the HF layout, read by ``make_embed_fn``, run by
``extract_embeddings`` and written by ``save_results``, against the JAX
package's embeddings and CSV contract (f32, 1e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from bvc_tpu.evalbench import extract as jax_extract
from bvc_tpu.evalbench.datasets import drop_none_collate as jax_drop_none_collate
from bvc_tpu.models import videomae as jax_videomae
from bvc_tpu.models.torch_interop import videomae_to_hf_state_dict
from bvc_tpu.utils.config import ModelConfig as JaxModelConfig
from bvc_tpu_torch.evalbench.extract import (
    drop_none_collate,
    extract_embeddings,
    make_embed_fn,
    merge_gathered,
    run_id_from_checkpoint,
    save_results,
    untrained_embed_fn,
)
from bvc_tpu_torch.utils.config import ModelConfig

SMALL = dict(image_size=32, patch_size=8, num_frames=4, tubelet_size=2,
             hidden_size=24, depth=2, num_heads=2, mlp_ratio=2.0,
             decoder_hidden_size=16, decoder_depth=1, decoder_num_heads=2,
             dtype="float32")
RUN_ID = "dev_1_g0_default_0_0"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class ClipDataset:
    """In-memory ``(clip, fname)`` samples; ``None`` clips stand for
    unreadable videos, and one name repeats to exercise the dedup."""

    def __init__(self, clips, names):
        self.clips, self.names = clips, names

    def __len__(self):
        return len(self.names)

    def __getitem__(self, i):
        return self.clips[i], self.names[i]


def test_pth_tar_entry_point_matches_jax(tmp_path):
    jcfg = JaxModelConfig(**SMALL)
    tree = jax_videomae.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(0, 0.02, x.shape).astype(np.float32), tree)
    ckpt = tmp_path / f"model_{RUN_ID}.pth.tar"
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in videomae_to_hf_state_dict(tree, jcfg).items()}
    torch.save({"model_state_dict": sd, "opt": None, "epoch": 1}, ckpt)

    n = 7
    clips = rng.integers(0, 256, (n, 4, 32, 32, 3), dtype=np.uint8)
    names = [f"vid_{i:02d}" for i in range(n)]
    names[6] = "vid_03"  # duplicate name: save_results keeps the first row
    samples = [None if i == 2 else clips[i] for i in range(n)]
    ds = ClipDataset(samples, list(names))

    fn = make_embed_fn("videomae", str(ckpt), ModelConfig(**SMALL), device="cpu")
    assert fn.feature_dim == SMALL["hidden_size"]
    got_names, embs = extract_embeddings(fn, ds, batch_size=4, num_workers=2)
    kept = [i for i in range(n) if i != 2]
    assert got_names == [names[i] for i in kept]

    # k bias does not reach the output (it shifts every score of a query by
    # the same amount), so the JAX embed of the original tree is the target
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    ref = np.asarray(jax_videomae.embed(params, jnp.asarray(clips[kept]), jcfg))
    assert np.abs(embs - ref).max() <= 1e-4

    path = save_results(got_names, embs, "test", run_id_from_checkpoint(str(ckpt)),
                        str(tmp_path / "port"))
    jax_path = jax_extract.save_results(got_names, ref, "test", RUN_ID, str(tmp_path / "jax"))
    assert path.endswith(f"test/embeddings_{RUN_ID}.csv")
    ours, theirs = pd.read_csv(path), pd.read_csv(jax_path)
    assert list(ours.columns) == list(theirs.columns)
    assert list(ours.columns) == ["fnames"] + [f"dim{i}" for i in range(SMALL["hidden_size"])]
    assert list(ours["fnames"]) == list(theirs["fnames"]) == sorted(set(got_names))
    np.testing.assert_allclose(ours.iloc[:, 1:].to_numpy(), theirs.iloc[:, 1:].to_numpy(),
                               rtol=0, atol=1e-4 + 1e-6)


def test_train_split_goes_to_savedir(tmp_path):
    path = save_results(["b", "a"], np.ones((2, 3), np.float32), "train", RUN_ID,
                        str(tmp_path))
    assert path == str(tmp_path / f"embeddings_{RUN_ID}.csv")
    assert list(pd.read_csv(path)["fnames"]) == ["a", "b"]


def test_untrained_embed_fn_and_empty_dataset():
    fn = untrained_embed_fn("videomae", ModelConfig(**SMALL), seed=0, device="cpu")
    names, embs = extract_embeddings(fn, ClipDataset([], []), batch_size=4)
    assert names == [] and embs.shape == (0, SMALL["hidden_size"])
    clips = np.zeros((2, 4, 32, 32, 3), np.uint8)
    out = fn(clips)
    assert out.shape == (2, SMALL["hidden_size"]) and np.isfinite(out).all()


@pytest.mark.parametrize("family", ["jepa", "simclr"])
def test_other_families_name_their_slice(family, tmp_path):
    """The other families embed: JEPA (tests/test_torch_jepa.py), drop-path
    included, which draws nothing when embedding; SimCLR from a
    ``model_state_dict`` in torchvision names, against the JAX package's
    embed (``resnet.apply`` on the last frame, eval BatchNorm, no head) on
    the same weights and running statistics (f32, 1e-4 of max|ref| plus
    1e-5)."""
    if family == "jepa":
        cfg = ModelConfig(**SMALL, drop_path_rate=0.1)
        clips = np.random.default_rng(2).integers(0, 256, (2, 4, 32, 32, 3), dtype=np.uint8)
        out = untrained_embed_fn(family, cfg, device="cpu")(clips)
        ref = untrained_embed_fn(family, ModelConfig(**SMALL), device="cpu")(clips)
        np.testing.assert_array_equal(out, ref)
        return
    from bvc_tpu.models import resnet as jax_resnet
    from bvc_tpu.models.torch_interop import resnet_to_torch_state_dict

    params, stats = jax.tree_util.tree_map(
        np.asarray, jax_resnet.init_params(jax.random.PRNGKey(3), "resnet18", 16))
    rng = np.random.default_rng(3)
    stats = jax.tree_util.tree_map(  # running statistics off their init values
        lambda x: (x + rng.uniform(0, 0.5, x.shape)).astype(np.float32), stats)
    ckpt = tmp_path / f"model_{RUN_ID}.pth.tar"
    torch.save({"model_state_dict": {k: torch.from_numpy(np.array(v)) for k, v in
                                     resnet_to_torch_state_dict(params, stats, "resnet18").items()}},
               ckpt)
    cfg = ModelConfig(family="simclr", architecture="resnet18", image_size=32, num_frames=3)
    fn = make_embed_fn(family, str(ckpt), cfg, device="cpu")
    clips = rng.normal(0, 1, (3, 3, 32, 32, 3)).astype(np.float32)
    got = fn(clips)
    want = np.asarray(jax_resnet.apply(params, stats, jnp.asarray(clips[:, -1]), "resnet18",
                                       training=False, with_head=False)[0])
    assert fn.feature_dim == 512 and got.shape == (3, 512) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max() + 1e-5)
    assert not fn.model.training
    untrained = untrained_embed_fn(family, cfg, seed=1, device="cpu")
    assert untrained(clips).shape == (3, 512)
    with pytest.raises(ValueError, match="resnet conv trunk"):
        untrained_embed_fn(family, cfg, device="cpu", quantize="int8")


def test_collate_and_merge_match_jax():
    a = np.ones((2, 3), np.float32)
    samples = [(a, "x"), (None, "y"), (2 * a, "z")]
    for ours, theirs in zip(drop_none_collate(samples), jax_drop_none_collate(samples)):
        np.testing.assert_array_equal(np.asarray(ours), np.asarray(theirs))
    assert drop_none_collate([(None, "y")])[1] == []
    cases = [
        [{"fnames": ["a"], "embeddings": np.ones((1, 4))},
         {"fnames": [], "embeddings": np.zeros((0, 1))}],
        [{"fnames": [], "embeddings": np.zeros((0, 1))},
         {"fnames": [], "embeddings": np.zeros((0, 5))}],
    ]
    for gathered in cases:
        (n1, e1), (n2, e2) = merge_gathered(gathered), jax_extract.merge_gathered(gathered)
        assert n1 == n2
        np.testing.assert_array_equal(e1, e2)


@pytest.mark.parametrize("fp", ["model_dev_1_g0_default_0_0.pth.tar",
                                "/x/model_adev_2_g1_shuffle_1_3.ckpt", "untrained"])
def test_run_id_from_checkpoint_matches_jax(fp):
    assert run_id_from_checkpoint(fp) == jax_extract.run_id_from_checkpoint(fp)
