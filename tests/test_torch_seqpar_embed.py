"""Sequence-parallel extraction and the CLIs on a ``seq`` mesh (slice 7c).

- ``seq_embed`` of VideoMAE and V-JEPA encoders on two gloo ranks (``--mesh
  data=1,seq=2``, each rank its time slice) against the JAX package's
  single-device ``videomae.embed`` and ``jepa.embed`` on the same weights
  and clips, at ``tests/test_seqpar.py``'s rtol 1e-4, atol 1e-5 (f32);
- ``compute_embeddings --mesh data=1,seq=2`` on two gloo ranks writes the
  CSV one process writes (V-JEPA tiny, f32; 6-decimal CSVs, atol 1e-5);
- ``pretrain_videomae --mesh data=1,seq=2`` on two gloo ranks, a 3-step
  stage, writes the CSV losses one process writes at the same global batch
  (rtol 1e-5, the CSV's 5 decimals);
- the refusals: SimCLR on a ``seq`` mesh, with JAX's reason, and a V-JEPA
  time slice at another image size (the resized position table).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from bvc_tpu.models import jepa as jax_jepa
from bvc_tpu.models import videomae as jax_videomae
from bvc_tpu.utils.config import ModelConfig as JaxModelConfig
from bvc_tpu_torch.cli import compute_embeddings, pretrain_videomae
from bvc_tpu_torch.evalbench.extract import untrained_embed_fn
from bvc_tpu_torch.models.convert import jepa_encoder_from_jax_params, videomae_from_jax_params
from bvc_tpu_torch.models.jepa import JEPAEncoder
from bvc_tpu_torch.utils.config import ModelConfig
from torch_ranks import run_ranks
from torch_tiny_runs import shrink_videomae

VIDEOMAE = dict(image_size=32, patch_size=8, num_frames=8, tubelet_size=2, hidden_size=32,
                depth=2, num_heads=4, decoder_hidden_size=16, decoder_depth=1,
                decoder_num_heads=2, dtype="float32")
JEPA = dict(family="jepa", image_size=32, patch_size=8, num_frames=8, tubelet_size=1,
            hidden_size=16, depth=2, num_heads=2, dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_seq_embeds_match_jax(tmp_path):
    video = np.random.default_rng(5).integers(0, 255, (4, 8, 32, 32, 3)).astype(np.float32)
    spec, want = {"mesh": {"data": 1, "seq": 2}}, {}
    for family, fields, init, embed, convert in (
            ("videomae", VIDEOMAE, jax_videomae.init_params, jax_videomae.embed,
             videomae_from_jax_params),
            ("jepa", JEPA, jax_jepa.init_encoder_params, jax_jepa.embed,
             jepa_encoder_from_jax_params)):
        jcfg = JaxModelConfig(**fields)
        tree = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0), jcfg))
        want[family] = np.asarray(embed(tree, jnp.asarray(video), jcfg))
        spec[family] = {"model": fields, "weights": convert(tree, ModelConfig(**fields)),
                        "clips": video}
    ranks = run_ranks("seq_embeds", spec, tmp_path, module="torch_seq_ranks")
    for r, res in enumerate(ranks):
        for family in ("videomae", "jepa"):
            np.testing.assert_allclose(res[family], want[family], rtol=1e-4, atol=1e-5,
                                       err_msg=f"{family} rank {r}")


def test_compute_embeddings_over_a_seq_ring(tmp_path, monkeypatch):
    from test_torch_compute_embeddings import write_cifar

    root = write_cifar(tmp_path / "cifar")
    argv = ["-ds_task", "cifar10", "-vid_root", root, "--family", "jepa", "--architecture",
            "tiny", "--num_frames", "2", "--tubelet_size", "1", "--image_size", "32",
            "--batch_size", "4", "--num_workers", "1", "--dataset_split", "test"]
    ranks = run_ranks("compute_embeddings", {
        "argv": argv + ["-savedir", str(tmp_path / "seq"), "--mesh", "data=1,seq=2"],
        "dtype": "float32"}, tmp_path / "ranks", module="torch_seq_ranks", timeout=180)
    assert [r["rows"] for r in ranks[0]] == [10] and ranks[1] == []
    parse = compute_embeddings.model_config_from_args

    def f32(args):
        cfg = parse(args)
        cfg.dtype = "float32"
        return cfg

    monkeypatch.setattr(compute_embeddings, "model_config_from_args", f32)
    one = compute_embeddings.main(argv + ["-savedir", str(tmp_path / "one")], device="cpu")
    got, want = pd.read_csv(ranks[0][0]["csv"]), pd.read_csv(one[0]["csv"])
    assert list(got["fnames"]) == list(want["fnames"]) and got.shape == (10, 193)
    np.testing.assert_allclose(got.iloc[:, 1:].to_numpy(), want.iloc[:, 1:].to_numpy(),
                               rtol=0, atol=1e-5)


def test_pretrain_videomae_over_a_seq_ring(frame_corpus, tmp_path, monkeypatch):
    from test_torch_cli import _argv

    rid = "dev_1_g0_default_0_0"
    ranks = run_ranks("pretrain_videomae", {
        "argv": _argv("videomae", frame_corpus, tmp_path / "seq", "--mesh", "data=1,seq=2",
                      "--max_epoch_iters", "3")}, tmp_path / "ranks",
        module="torch_seq_ranks", timeout=180)
    assert ranks[0]["checkpoint"] == str(tmp_path / "seq" / f"model_{rid}.pth.tar")
    monkeypatch.setattr(pretrain_videomae, "config_from_args",
                        pretrain_videomae.config_from_args)
    shrink_videomae(pretrain_videomae)
    pretrain_videomae.main(_argv("videomae", frame_corpus, tmp_path / "one",
                                 "--max_epoch_iters", "3"), device="cpu")

    def losses(folder):
        csv = pd.read_csv(tmp_path / folder / f"csvlog_{rid}.csv")
        return csv["train loss"].to_numpy()

    got, want = losses("seq"), losses("one")
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_seq_extraction_refuses_simclr_and_resized_tables():
    cfg = ModelConfig(family="simclr", architecture="resnet18", image_size=32, num_frames=2,
                      tubelet_size=1)
    with pytest.raises(ValueError, match="supports videomae and jepa"):
        untrained_embed_fn("simclr", cfg, device="cpu", mesh_shape={"data": 1, "seq": 2})
    enc = JEPAEncoder(ModelConfig(**JEPA))
    with pytest.raises(ValueError, match="resized position table"):
        enc(torch.zeros((1, 4, 48, 48, 3)), token_offset=0)
