"""Checkpoints across parameter layouts: a VideoMAE stage's checkpoint is
one ``.pth.tar`` in the export layout whatever ``--param_sharding`` wrote
it (rank 0 writes whole tensors: FSDP2's gathered, ZeRO's consolidated,
the heads gathered back into ``[3D, D]`` order), so it resumes under any
other mode.  Two chains, each stopped after its first epoch and resumed
for a second, against one process running both epochs at the same global
batch of 8 (gloo ranks on the CPU, ``tests/test_torch_sharding_ranks.py``):

- written under ``fsdp`` at ``data=2``, resumed under ``replicated`` in one
  process;
- written under ``tp`` at ``data=1,model=2``, resumed under ``zero1`` at
  ``data=2``;
- written under ``zero1`` at ``data=2`` (the partitions consolidated on
  rank 0), resumed under ``fsdp`` at ``data=2`` (each rank taking its
  shards of the weights and the momentum).

The resumed run's final weights, optimizer state and its second epoch's
losses equal the uninterrupted run's within rtol 1e-5, atol 1e-6 (the same
sums in another order); the files hold the same keys, shapes and meta.
And ``run_curriculum`` hands ``param_sharding`` to every stage and to
the commands it emits.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bvc_tpu_torch.curriculum import driver
from bvc_tpu_torch.curriculum.presets import FAMILY_PRESETS
from bvc_tpu_torch.training.checkpoint import load_checkpoint
from bvc_tpu_torch.training.trainer_videomae import run_pretraining
from bvc_tpu_torch.utils.config import TrainConfig
from torch_ranks import run_ranks
from torch_tiny_runs import tiny_cfg

RTOL, ATOL = 1e-5, 1e-6
RUN_ID = "dev_1_g0_default_0_0"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def straight(frame_corpus, tmp_path_factory):
    """One process, two epochs at a batch of 8: the checkpoint and the CSV
    rows."""
    out = tmp_path_factory.mktemp("straight")
    run_pretraining(tiny_cfg(TrainConfig, "videomae", frame_corpus, out, RUN_ID, batch_size=8,
                             n_epoch=2), device="cpu")
    return load_checkpoint(out / f"model_{RUN_ID}.pth.tar"), _rows(out)


def _rows(folder) -> list[list[float]]:
    lines = (folder / f"csvlog_{RUN_ID}.csv").read_text().splitlines()[1:]
    return [[float(x) for x in line.split(",")] for line in lines]


def _assert_same_run(got: dict, got_rows, want: dict, want_rows):
    assert set(got) == set(want)
    assert got["meta"]["epoch"] == want["meta"]["epoch"] == 2 and got["step"] == want["step"]
    for key in ("model_state_dict", "qkv_k_bias"):
        assert set(got[key]) == set(want[key])
        for k, w in want[key].items():
            assert got[key][k].shape == w.shape, k
            np.testing.assert_allclose(got[key][k].numpy(), w.numpy(), rtol=RTOL, atol=ATOL,
                                       err_msg=k)
    assert got["opt"]["param_groups"] == want["opt"]["param_groups"]
    for i, st in want["opt"]["state"].items():
        np.testing.assert_allclose(got["opt"]["state"][i]["momentum_buffer"].numpy(),
                                   st["momentum_buffer"].numpy(), rtol=RTOL, atol=ATOL)
    assert len(got_rows) == len(want_rows) == 2 * 3
    np.testing.assert_allclose(np.array(got_rows), np.array(want_rows), rtol=RTOL, atol=ATOL)


# (id): (writer's mode, mesh), (resumer's mode, mesh); a mesh of None is one
# process, with no group
CHAINS = {"fsdp-to-replicated": (("fsdp", {"data": 2}), ("replicated", None)),
          "tp-to-zero1": (("tp", {"data": 1, "model": 2}), ("zero1", {"data": 2})),
          "zero1-to-fsdp": (("zero1", {"data": 2}), ("fsdp", {"data": 2}))}


def _stage(corpus, savedir, mode, mesh, n_epoch, tmp, resume=False):
    if mesh is None:
        return run_pretraining(tiny_cfg(TrainConfig, "videomae", corpus, savedir, RUN_ID,
                                        batch_size=8, n_epoch=n_epoch, resume=resume),
                               device="cpu")
    return run_ranks("stage", {"family": "videomae", "corpus": corpus, "savedir": str(savedir),
                               "run_id": RUN_ID, "batch_size": 8 // 2, "mode": mode,
                               "mesh": mesh, "cfg": {"n_epoch": n_epoch, "resume": resume}},
                     tmp, world=2, module="test_torch_sharding_ranks")


@pytest.mark.parametrize("chain", list(CHAINS))
def test_checkpoint_resumes_under_another_layout(chain, frame_corpus, straight, tmp_path):
    """A stage's first epoch under the writer's layout, its checkpoint then
    resumed for the second epoch under the resumer's: the same run as one
    process's two epochs.  The written file holds whole tensors (under
    ``tp`` the heads gathered back: HF's whole query)."""
    (w_mode, w_mesh), (r_mode, r_mesh) = CHAINS[chain]
    run = tmp_path / "run"
    _stage(frame_corpus, run, w_mode, w_mesh, 1, tmp_path / "writer")
    written = load_checkpoint(run / f"model_{RUN_ID}.pth.tar")
    assert written["world_size"] == 2 and written["meta"]["epoch"] == 1
    query = "videomae.encoder.layer.0.attention.attention.query.weight"
    assert written["model_state_dict"][query].shape == (32, 32)
    _stage(frame_corpus, run, r_mode, r_mesh, 2, tmp_path / "resumer", resume=True)
    _assert_same_run(load_checkpoint(run / f"model_{RUN_ID}.pth.tar"), _rows(run), *straight)


def test_curriculum_hands_the_layout_to_every_stage(tmp_path, monkeypatch):
    """``base.param_sharding`` reaches every stage's config, and the
    emitted script launches each stage under torchrun over the mesh's
    ranks with the flag (the extraction sweep takes the mesh alone)."""
    seen = []

    def trainer(cfg, device=None):
        seen.append((cfg.param_sharding, cfg.mesh_shape))
        return {"checkpoint": str(tmp_path / f"{cfg.run_id}.pth.tar")}

    monkeypatch.setattr(driver, "_trainer_for", lambda family: trainer)
    base = TrainConfig(savedir=str(tmp_path), param_sharding="zero1")
    driver.run_curriculum("dev", "generative", base, device="cpu")
    assert seen == [("zero1", {})] * 3
    script = driver.emit_script("dev", FAMILY_PRESETS["generative"], 7,
                                extract={"ssv2": "/data"}, mesh="data=2,model=2",
                                param_sharding="tp")
    stages = [line for line in script.splitlines() if "pretrain_videomae" in line]
    assert len(stages) == 3 and all(
        line.startswith("torchrun --nproc_per_node 4 -m bvc_tpu_torch.cli.pretrain_videomae "
                        "--mesh data=2,model=2 --param_sharding tp") for line in stages)
    sweep = [line for line in script.splitlines() if "compute_embeddings" in line]
    assert sweep and "--param_sharding" not in sweep[0] and "--mesh data=2,model=2" in sweep[0]
