"""The distributed runtime of the port (``bvc_tpu_torch.parallel``) and
data-parallel extraction.

In one process: the loader's rank blocks against ``bvc_tpu``'s
``EpochSampler`` cut by hand, ``host_local_batch_slice``, ``--mesh``
parsing and the layouts that raise (a ``data`` size that is not the
world's, a ``pipe`` axis beside ``seq`` or ``model``, rendezvous
variables missing), the plans of the parameter layouts, and
``distributed_init`` with none set.  At world 2 (two gloo processes,
``tests/torch_ranks.py``): the collectives, with one rank holding an empty
list and zero rows; ``extract_embeddings`` over 11 clips with one
unreadable, every rank making the same count of calls; and
``compute_embeddings --mesh data=2`` against one process: the same CSV rows
(ResNet-18 f32, to the CSV's 6 decimals: atol 2e-6), ``--resume y`` with a
CSV present, and W8A8 (JEPA ViT-tiny) within 1e-4, the counterpart of
``tests/test_quant.py``'s data-mesh case.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import pytest
import torch

from bvc_tpu.data.loader import EpochSampler as JaxEpochSampler
from bvc_tpu_torch.cli import compute_embeddings
from bvc_tpu_torch.cli.common import parse_mesh
from bvc_tpu_torch.data.loader import EpochSampler
from bvc_tpu_torch.evalbench.extract import _check_quantize, extract_embeddings
from bvc_tpu_torch.parallel import (Mesh, ShardingPlan, distributed_init,
                                    host_local_batch_slice, make_mesh, param_shardings)
from bvc_tpu_torch.parallel import sharding
from test_torch_compute_embeddings import write_cifar
from torch_ranks import OddClips, run_ranks, simclr_embed_fn


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _as_rank(monkeypatch, world: int, r: int) -> None:
    """This process as data rank ``r`` of ``world`` (the batch is split
    over the mesh's data axis)."""
    monkeypatch.setattr(sharding, "data_size", lambda: world)
    monkeypatch.setattr(sharding, "data_rank", lambda: r)


@pytest.mark.parametrize("n,batch,world,shuffle,drop_last", [
    (37, 8, 2, True, True), (37, 8, 4, True, False), (30, 6, 3, False, True),
    (5, 4, 2, True, False)], ids=["shuffle", "padded", "ordered", "smaller_than_batch"])
def test_epoch_sampler_blocks_match_jax(n, batch, world, shuffle, drop_last, monkeypatch):
    """Rank r's batches are the r-th contiguous block of JAX's global
    batches (its sampler in one process, cut by hand), every epoch."""
    ref = JaxEpochSampler(n, batch, shuffle, seed=3, drop_last=drop_last)
    per = batch // world
    for r in range(world):
        _as_rank(monkeypatch, world, r)
        sampler = EpochSampler(n, batch, shuffle, seed=3, drop_last=drop_last)
        for epoch in (0, 1):
            got = sampler.batches(epoch)
            want = [b[r * per:(r + 1) * per] for b in ref.batches(epoch)]
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


def test_host_local_batch_slice(monkeypatch):
    assert host_local_batch_slice(8) == (0, 8)
    _as_rank(monkeypatch, 4, 3)
    assert host_local_batch_slice(8) == (6, 2)
    with pytest.raises(ValueError, match="does not divide evenly over 4"):
        host_local_batch_slice(6)
    with pytest.raises(ValueError, match="does not divide evenly"):
        EpochSampler(10, 6, True)


@pytest.mark.parametrize("spec,want", [("", {}), ("data=2", {"data": 2}),
                                       ("data=2, seq=4", {"data": 2, "seq": 4}),
                                       ("data=-1", {"data": -1})])
def test_parse_mesh(spec, want):
    assert parse_mesh(spec) == want


@pytest.mark.parametrize("spec,match", [("data", "expected axis=size"),
                                        ("=2", "expected axis=size"),
                                        ("data=two", "not an integer")])
def test_parse_mesh_errors(spec, match):
    with pytest.raises(ValueError, match=match):
        parse_mesh(spec)


def test_make_mesh_in_one_process(monkeypatch):
    """Every form of a world of 1 gives ``{'data': 1}``; ``data=2`` and
    ``data=1,model=2`` raise, naming the 2 processes they need (no run
    quietly uses one rank of two); ``model=1`` beside ``data=-1`` is a
    world of 1; so is ``seq=1`` (``data`` x ``seq`` x ``model`` laid out in
    that order), while ``seq=2`` needs 2 processes; so do ``pipe=1`` (laid
    out after ``data``) and ``pipe=2``, and ``pipe`` beside ``seq`` raises;
    ``WORLD_SIZE`` > 1 without a process group raises."""
    for shape in (None, {}, {"data": 1}, {"data": -1}):
        mesh = make_mesh(shape)
        assert mesh.shape == {"data": 1} and mesh.size == 1 and mesh.axis_names == ("data",)
    with pytest.raises(ValueError, match="needs 2 processes, this run has 1"):
        make_mesh({"data": 2})
    with pytest.raises(ValueError, match="needs 2 processes, this run has 1"):
        make_mesh({"data": 1, "model": 2})
    mesh = make_mesh({"data": -1, "model": 1})
    assert mesh.shape == {"data": 1, "model": 1} and mesh.axis_names == ("data", "model")
    mesh = make_mesh({"model": 1, "seq": 1})
    assert mesh.axis_names == ("data", "seq", "model") and mesh.size == 1
    assert mesh.coords == {"data": 0, "seq": 0, "model": 0} and mesh.gradient_size() == 1
    with pytest.raises(ValueError, match="needs 2 processes, this run has 1"):
        make_mesh({"data": 1, "seq": 2})
    with pytest.raises(ValueError, match="needs 2 processes, this run has 1"):
        make_mesh({"data": 1, "pipe": 2})
    mesh = make_mesh({"pipe": 1})
    assert mesh.axis_names == ("data", "pipe") and mesh.coords == {"data": 0, "pipe": 0}
    with pytest.raises(ValueError, match="runs beside 'data' only"):
        make_mesh({"data": 1, "seq": 1, "pipe": 1})
    with pytest.raises(ValueError, match="unknown mesh axis"):
        make_mesh({"rows": 2})
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="no process group is initialised"):
        make_mesh({})


@pytest.mark.parametrize("mode", ["zero1", "fsdp", "tp"])
def test_param_shardings_name_slice_7b(mode):
    """Since slice 7b each mode returns its plan: which axis splits the
    parameters and the optimizer state.  ``tp`` without a model axis of
    more than one rank is the replicated layout (as in the JAX package);
    ``zero1`` and ``fsdp`` beside ``model > 1`` shard over ``data`` with the
    model ranks as replicas (slice 7d); on a ``pipe`` mesh the stages are
    the layout and only ``replicated`` is taken."""
    assert param_shardings("replicated") == ShardingPlan("replicated")
    want = {"zero1": ShardingPlan("zero1", optimizer="data"),
            "fsdp": ShardingPlan("fsdp", params="data"), "tp": ShardingPlan("tp")}[mode]
    assert param_shardings(mode) == want
    two = Mesh(("data", "model"), {"data": 1, "model": 2}, {"data": 0, "model": 0})
    if mode == "tp":
        assert param_shardings(mode, two) == ShardingPlan("tp", params="model")
    else:
        assert param_shardings(mode, two) == ShardingPlan(
            mode, **{("optimizer" if mode == "zero1" else "params"): "data"},
            replicas="model")
    pipe = Mesh(("data", "pipe"), {"data": 1, "pipe": 2}, {"data": 0, "pipe": 0})
    assert param_shardings("replicated", pipe) == ShardingPlan("pipe", params="pipe")
    with pytest.raises(ValueError, match="defines its own stage sharding"):
        param_shardings(mode, pipe)
    with pytest.raises(ValueError, match="unknown param_sharding"):
        param_shardings("sharded")


def test_distributed_init_without_a_launcher_is_a_no_op(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
              "BVC_COORDINATOR"):
        monkeypatch.delenv(k, raising=False)
    distributed_init(device="cpu")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("env,match", [
    ({"RANK": "0", "WORLD_SIZE": "2"}, "LOCAL_RANK, MASTER_ADDR, MASTER_PORT not"),
    ({"BVC_COORDINATOR": "localhost:1234", "SLURM_NTASKS": "2"}, "SLURM_PROCID is not"),
], ids=["torchrun", "slurm"])
def test_distributed_init_refuses_a_partial_rendezvous(env, match, monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
              "BVC_COORDINATOR", "SLURM_NTASKS", "SLURM_PROCID"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match=match):
        distributed_init(device="cpu")
    assert not torch.distributed.is_initialized()


def test_distributed_init_takes_nccl_on_cuda(monkeypatch):
    """On ``cuda`` (named or by default) the group is NCCL's and the rank's
    GPU is ``LOCAL_RANK``, set before the group is made; gloo only when the
    caller names it (then still on the rank's GPU) or on the CPU."""
    from bvc_tpu_torch.parallel import mesh

    env = {"RANK": "1", "WORLD_SIZE": "4", "LOCAL_RANK": "3", "MASTER_ADDR": "localhost",
           "MASTER_PORT": "1"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: calls.append(("set_device", i)))
    monkeypatch.setattr(mesh.dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw["world_size"],
                                                            kw["rank"])))
    for kwargs, want in (({}, [("set_device", 3), ("nccl", 4, 1)]),
                         ({"device": "cuda"}, [("set_device", 3), ("nccl", 4, 1)]),
                         ({"backend": "gloo"}, [("set_device", 3), ("gloo", 4, 1)]),
                         ({"device": "cpu"}, [("gloo", 4, 1)])):
        calls.clear()
        distributed_init(**kwargs)
        assert calls == want, kwargs


def test_resolve_device_is_the_ranks_gpu_under_a_group(monkeypatch):
    from bvc_tpu_torch.utils import device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert device.resolve_device() == torch.device("cuda")
    monkeypatch.setattr(device.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert device.resolve_device() == torch.device("cuda", 3)
    assert device.resolve_device("cuda") == torch.device("cuda", 3)
    assert device.resolve_device("cuda:1") == torch.device("cuda", 1)
    assert device.resolve_device("cpu") == torch.device("cpu")


def test_int8_refused_on_a_seq_mesh_only():
    assert _check_quantize("jepa", "int8", {"data": 2})
    assert not _check_quantize("jepa", "none", {"data": 1, "seq": 2})
    with pytest.raises(ValueError, match="sequence-parallel"):
        _check_quantize("videomae", "int8", {"data": 1, "seq": 2})


def test_collectives_at_world_2(tmp_path):
    results = run_ranks("collectives", {}, tmp_path)
    weights = torch.arange(12.0).reshape(4, 3)
    for r, out in enumerate(results):
        assert out["world"] == 2
        assert out["gathered"][0]["fnames"] == ["a", "b", "c"]
        assert out["gathered"][1]["fnames"] == [] and out["gathered"][1]["embeddings"].shape == (0, 4)
        assert out["names"] == ["a", "b", "c"] and out["rows"].shape == (3, 4)
        assert torch.equal(out["g"], torch.tensor([[1.0] * 3] * 2 + [[2.0] * 3] * 2))
        # every rank computes the same loss of the gathered rows: each rank's
        # gradient is world x its share, which DDP's mean divides out
        assert torch.equal(out["x_grad"], 2 * weights[2 * r:2 * r + 2])
        assert out["s"].item() == 6.0 and out["y_grad"].item() == 6.0
        assert out["mean"] == 0.5


def test_make_mesh_reuses_its_groups_at_world_2(tmp_path):
    """``data=1,model=2`` creates one group per model column (a rank each);
    asked again for the same layout, as every curriculum stage asks,
    ``make_mesh`` returns the mesh it holds and creates none; another
    layout, and then the first again, build anew."""
    model2 = {"data": 1, "model": 2}
    results = run_ranks("mesh_groups", {"shapes": [model2, model2, {"data": 2}, model2]},
                        tmp_path)
    for r, out in enumerate(results):
        assert out == [(2, False, model2, {"data": 0, "model": r}),
                       (0, True, model2, {"data": 0, "model": r}),
                       (0, False, {"data": 2}, {"data": r}),
                       (2, False, model2, {"data": 0, "model": r})]


def test_extraction_at_world_2(tmp_path):
    """11 clips, clip 5 unreadable, batches of 5: rank 0 embeds 0, 2, .., 10
    in two calls, rank 1 1, 3, 7, 9 in one and then a one-clip dummy call;
    the gathered rows are one process's (rank order), every rank has them."""
    calls: list[int] = []
    names, embs = extract_embeddings(simclr_embed_fn(calls), OddClips(), 5, num_workers=1)
    assert calls == [5, 4, 1] and len(names) == 10
    results = run_ranks("extract", {"batch_size": 5}, tmp_path)
    assert results[0]["calls"] == [5, 1] and results[1]["calls"] == [4, 1]
    for out in results:
        assert out["names"] == [f"clip_{i:02d}" for i in (0, 2, 4, 6, 8, 10, 1, 3, 7, 9)]
        order = [names.index(n) for n in out["names"]]
        np.testing.assert_allclose(out["embs"], embs[order], rtol=0, atol=1e-5)


def _argv(root, out, family="simclr", *extra):
    flags = (["--architecture", "resnet18"] if family == "simclr" else
             ["--architecture", "tiny", "--tubelet_size", "1", "--quantize", "int8"])
    return ["-ds_task", "cifar10", "-vid_root", root, "-savedir", str(out), "--family",
            family, "--batch_size", "4", "--num_workers", "1", "--num_frames", "2",
            "--image_size", "32", *flags, *extra]


def _frame(path) -> pd.DataFrame:
    return pd.read_csv(path)


@pytest.mark.parametrize("family", ["simclr", "jepa"], ids=["simclr", "jepa_w8a8"])
def test_compute_embeddings_mesh_data_2(family, tmp_path, capsys):
    """9 test images (an odd count) over two ranks; rank 0 writes the CSV,
    the same rows as one process's; ``--resume y`` then runs only the train
    split, on both ranks."""
    root = write_cifar(tmp_path / "cifar", n_test=9)
    one = compute_embeddings.main(_argv(root, tmp_path / "one", family, "--dataset_split",
                                        "test"), device="cpu")
    capsys.readouterr()
    argv = _argv(root, tmp_path / "two", family, "--mesh", "data=2")
    results = run_ranks("compute_embeddings", {"argv": argv + ["--dataset_split", "test"]},
                        tmp_path / "ranks", timeout=180)
    assert results[1] == [] and [r["rows"] for r in results[0]] == [9] == [one[0]["rows"]]
    got, want = _frame(results[0][0]["csv"]), _frame(one[0]["csv"])
    assert list(got["fnames"]) == list(want["fnames"])
    atol = 2e-6 if family == "simclr" else 1e-4
    np.testing.assert_allclose(got.iloc[:, 1:].to_numpy(), want.iloc[:, 1:].to_numpy(),
                               rtol=0, atol=atol)
    if family == "simclr":
        resumed = run_ranks("compute_embeddings", {"argv": argv + ["--resume", "y"]},
                            tmp_path / "resume", timeout=180)
        assert [r["phase"] for r in resumed[0]] == ["train"] and resumed[1] == []
        assert resumed[0][0]["rows"] == 20


def test_emit_script_launches_under_torchrun(tmp_path):
    """``--emit_script`` with ``--mesh data=4`` (in one process: the script
    runs later, under torchrun) writes each stage and the sweep as a
    torchrun command of 4 ranks, and asks SBATCH for 4 GPUs; without a mesh
    the commands stay ``python -m``; a ``seq`` or a ``pipe`` mesh launches as
    many ranks as its sizes multiply to, and ``pipe`` beside ``model``
    raises."""
    from bvc_tpu_torch.cli import run_curriculum
    from bvc_tpu_torch.curriculum.driver import emit_script

    out = tmp_path / "run.sh"
    run_curriculum.main(["-jpg_root", "/d", "-savedir", "/s", "--mesh", "data=4",
                         "--emit_script", str(out), "--extract", "ssv2=/v", "--sbatch", "y"],
                        device="cpu")
    text = out.read_text()
    assert text.count("torchrun --nproc_per_node 4 -m bvc_tpu_torch.cli.pretrain_videomae "
                      "--mesh data=4") == 3
    assert "torchrun --nproc_per_node 4 -m bvc_tpu_torch.cli.compute_embeddings --mesh data=4" \
        in text
    assert "#SBATCH --gres=gpu:4" in text and "python -m" not in text
    plain = emit_script("dev", "generative", 0, extract={"ssv2": "/v"})
    assert "torchrun" not in plain and plain.count("python -m bvc_tpu_torch.cli.") == 4
    seq = emit_script("dev", "generative", 0, mesh="data=2,seq=2", extract={"ssv2": "/v"})
    assert seq.count("torchrun --nproc_per_node 4 -m bvc_tpu_torch.cli.pretrain_videomae "
                     "--mesh data=2,seq=2") == 3
    pipe = emit_script("dev", "generative", 0, mesh="data=2,pipe=2", extract={"ssv2": "/v"})
    assert pipe.count("torchrun --nproc_per_node 4 -m bvc_tpu_torch.cli.pretrain_videomae "
                      "--mesh data=2,pipe=2") == 3
    assert "torchrun --nproc_per_node 4 -m bvc_tpu_torch.cli.compute_embeddings " \
           "--mesh data=2,pipe=2" in pipe
    with pytest.raises(ValueError, match="runs beside 'data' only"):
        emit_script("dev", "generative", 0, mesh="data=1,pipe=2,model=2")


def test_per_replica_blocks_hold_whole_pairs():
    """JAX's check that a shard holds whole (anchor, positive) pairs: a
    rank's block of interleaved rows must be even; an even block scores as
    the plain loss of its rows."""
    from bvc_tpu_torch.objectives.contrastive import (info_nce_loss,
                                                      per_replica_info_nce_sharded)

    feats = torch.from_numpy(np.random.default_rng(0).normal(size=(6, 8)).astype(np.float32))
    with pytest.raises(ValueError, match="whole pairs"):
        per_replica_info_nce_sharded(feats[:5])
    assert torch.equal(per_replica_info_nce_sharded(feats), info_nce_loss(feats))
