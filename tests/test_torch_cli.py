"""The port's pretraining CLIs: ``main(argv, device="cpu")`` writes the
artifacts with the JAX trainers' schemas, the same flags give the JAX CLIs'
configuration (``params_{run_id}.yaml`` loads to the same dict), the
multi-GPU flags that need more processes or a later slice raise,
``--log_grad_stats y`` appends the grad-stats table's suffix that JAX's
``format_gstats`` writes for the run's metrics,
and with no device named and no GPU ``main`` raises.

Tolerance: none; the yaml dumps load to equal dicts and the CSV headers and
log suffixes are equal strings.
"""

import json
import logging
import math

import pytest
import torch
import yaml

from bvc_tpu.cli import pretrain_jepa as jax_pretrain_jepa
from bvc_tpu.cli import pretrain_simclr as jax_pretrain_simclr
from bvc_tpu.cli import pretrain_videomae as jax_pretrain_videomae
from bvc_tpu.training.probes import format_gstats as jax_format_gstats
from bvc_tpu_torch.cli import pretrain_jepa, pretrain_simclr, pretrain_videomae
from bvc_tpu_torch.training import trainer_jepa, trainer_simclr, trainer_videomae
from torch_port_config import jax_comparable
from torch_tiny_runs import VIDEOMAE_MODEL

CLIS = {"videomae": (pretrain_videomae, jax_pretrain_videomae),
        "jepa": (pretrain_jepa, jax_pretrain_jepa),
        "simclr": (pretrain_simclr, jax_pretrain_simclr)}
TRAINERS = {"videomae": trainer_videomae, "jepa": trainer_jepa, "simclr": trainer_simclr}
HEADERS = {"videomae": "epoch,itr,train loss,val loss,grad-EFL,grad-ELL,grad-DLL",
           "jepa": "epoch,itr,loss,grad-FL,grad-LL,mask-A,mask-B,time (ms)",
           "simclr": "epoch,itr,train loss,grad-conv1,grad-fc0,time (ms)"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _argv(family, frame_corpus, savedir, *extra):
    common = ["-jpg_root", frame_corpus, "-savedir", str(savedir), "--batch_size", "4",
              "--n_trainsamples", "16", "--max_epoch_iters", "2", "--segment_minutes", "0.02",
              "--num_workers", "2", "--run_id", "dev_1_g0_default_0_0"]
    if family == "videomae":
        return common + ["--image_size", "32", "--num_frames", "4", *extra]
    if family == "simclr":
        return common + ["--image_size", "32", "--pred_emb_dim", "16", "--interval", "5",
                         "--augs", "n", *extra]
    return common + ["--image_size", "64", "--architecture", "tiny", "--pred_emb_dim", "24",
                     "--pred_depth", "1", "--interval", "5", *extra]


@pytest.fixture
def tiny_videomae(monkeypatch):
    """The VideoMAE CLI has no model-width flags: shrink the parsed config's
    model inside the test."""
    parse = pretrain_videomae.config_from_args

    def tiny(args):
        cfg = parse(args)
        for k, v in VIDEOMAE_MODEL.items():
            if k not in ("image_size", "num_frames", "tubelet_size", "patch_size"):
                setattr(cfg.model, k, v)
        cfg.model.patch_size = 8
        return cfg

    monkeypatch.setattr(pretrain_videomae, "config_from_args", tiny)


@pytest.mark.parametrize("family", ["videomae", "jepa", "simclr"])
def test_main_writes_the_artifacts(family, frame_corpus, tmp_path, capsys, request):
    if family == "videomae":
        request.getfixturevalue("tiny_videomae")
    port, _ = CLIS[family]
    summary = port.main(_argv(family, frame_corpus, tmp_path), device="cpu")
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == summary
    run_id = "dev_1_g0_default_0_0"
    ckpt = tmp_path / f"model_{run_id}.pth.tar"
    assert summary["checkpoint"] == str(ckpt) and ckpt.exists()
    rows = (tmp_path / f"csvlog_{run_id}.csv").read_text().splitlines()
    assert rows[0] == HEADERS[family] and len(rows) == 1 + 2
    meta = torch.load(ckpt, weights_only=True)["meta"]
    assert meta["run_id"] == run_id and meta["epoch"] == 1 and meta["family"] == family
    # a finished stage resumes at once, from the meta
    again = port.main(_argv(family, frame_corpus, tmp_path, "--resume", "y"), device="cpu")
    assert again["checkpoint"] == summary["checkpoint"]
    assert len((tmp_path / f"csvlog_{run_id}.csv").read_text().splitlines()) == 3


@pytest.mark.parametrize("family", ["videomae", "jepa", "simclr"])
def test_flags_give_the_jax_configuration(family, frame_corpus, tmp_path):
    port, ref = CLIS[family]
    argv = _argv(family, frame_corpus, tmp_path, "--lr", "0.05", "--wd", "0.01",
                 "--lr_schedule", "warmup_cosine", "--warmup_epochs", "0.5",
                 "--final_wd", "0.02", "--grad_accum_steps", "2", "--pack_root", "/p",
                 "--async_save", "y", "--save_every_epoch", "y", "--fold", "1")
    dumps = []
    for mod, name in ((port, "port.yaml"), (ref, "jax.yaml")):
        mod.config_from_args(mod.build_parser().parse_args(argv)).dump_yaml(tmp_path / name)
        dumps.append(yaml.safe_load((tmp_path / name).read_text()))
    port_dump = jax_comparable(dumps[0])
    assert port_dump == dumps[1]
    # the same keys in the same order, as the yaml text has them
    assert json.dumps(port_dump) == json.dumps(dumps[1])
    assert dumps[0]["optim"]["grad_accum_steps"] == 2


@pytest.mark.parametrize("family", ["videomae", "jepa", "simclr"])
def test_log_grad_stats_suffix_is_jax_format_gstats(family, frame_corpus, tmp_path, caplog,
                                                    monkeypatch, request):
    """``--log_grad_stats y``: the trainer's log line ends with the suffix
    JAX's ``format_gstats`` writes for the metrics of the same run."""
    if family == "videomae":
        request.getfixturevalue("tiny_videomae")
    module, seen = TRAINERS[family], []

    def spy(metrics):
        suffix = real(metrics)
        seen.append((dict(metrics), suffix))
        return suffix

    real = module.format_gstats
    monkeypatch.setattr(module, "format_gstats", spy)
    with caplog.at_level(logging.INFO):
        CLIS[family][0].main(_argv(family, frame_corpus, tmp_path, "--log_grad_stats", "y"),
                             device="cpu")
    assert len(seen) == 1  # log_freq 10: the first of the two steps
    metrics, suffix = seen[0]
    assert suffix == jax_format_gstats(metrics) and suffix.startswith(" [grad: ")
    assert all(math.isfinite(metrics[k]) for k in ("gstat_avg", "gstat_min", "gstat_max"))
    assert metrics["gstat_min"] <= metrics["gstat_avg"] <= metrics["gstat_max"]
    assert any(m.endswith(suffix) for m in caplog.messages)


@pytest.mark.parametrize("family", ["videomae", "jepa", "simclr"])
@pytest.mark.parametrize("flags,env,error,match", [
    (("--mesh", "data=2"), {}, ValueError, "needs 2 processes, this run has 1"),
    (("--param_sharding", "zero1"), {}, None, None),
    ((), {"WORLD_SIZE": "2"}, RuntimeError, "RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT not"),
    (("--mesh", "data=1,model=2"), {}, ValueError, "needs 2 processes, this run has 1"),
    (("--mesh", "data=1,seq=1"), {}, None, None),
    (("--mesh", "data=1,pipe=1"), {}, None, None),
], ids=["mesh", "param_sharding", "world_size", "model", "seq", "pipe"])
def test_unported_flags_raise(family, flags, env, error, match, frame_corpus, tmp_path,
                              monkeypatch, request):
    """The multi-GPU flags in one process: ``--mesh data=2`` and ``--mesh
    data=1,model=2`` raise, naming the 2 processes they need, and
    ``WORLD_SIZE`` without the other rendezvous variables raises in
    ``distributed_init``.  ``--mesh data=1,seq=1`` (slice 7c) runs VideoMAE
    through the sequence-parallel step (a ring of one), ``--mesh
    data=1,pipe=1`` (slice 7d) through the pipeline step (one stage), and
    the JEPA and SimCLR trainers refuse ``seq`` and ``pipe`` with the JAX
    trainers' reason.
    ``--param_sharding zero1`` (slice 7b) runs: one process holds the whole
    optimizer state, and the stage writes its CSV."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if family != "videomae" and flags[-1:] in (("data=1,seq=1",), ("data=1,pipe=1",)):
        error, match = ValueError, "videomae-only"
    port, _ = CLIS[family]
    csv = tmp_path / "csvlog_dev_1_g0_default_0_0.csv"
    if error is None:
        if family == "videomae":
            request.getfixturevalue("tiny_videomae")
        port.main(_argv(family, frame_corpus, tmp_path, *flags), device="cpu")
        assert len(csv.read_text().splitlines()) == 3
        return
    with pytest.raises(error, match=match):
        port.main(_argv(family, frame_corpus, tmp_path, *flags), device="cpu")
    assert not csv.exists()


@pytest.mark.parametrize("family", ["videomae", "jepa", "simclr"])
def test_main_without_a_gpu_or_a_device_raises(family, frame_corpus, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port, _ = CLIS[family]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.main(_argv(family, frame_corpus, tmp_path))


def test_profile_dir_writes_a_trace(frame_corpus, tmp_path):
    """``--profile_dir``: one torch.profiler trace of train steps 1-3 (here
    1 and 2, the stage ends first) and its summary."""
    prof = tmp_path / "prof"
    pretrain_jepa.main(_argv("jepa", frame_corpus, tmp_path, "--max_epoch_iters", "3",
                             "--n_trainsamples", "16", "--profile_dir", str(prof)),
                       device="cpu")
    summary = json.loads((prof / "summary.json").read_text())
    assert summary["steps"] == 2 and summary["wall_ms"] > 0
    assert summary["device_busy_ms"] == 0 and summary["idle_share"] == 1.0  # no device here
    assert summary["device_copy_ms"] == 0
    assert json.loads((prof / "trace.json").read_text())["traceEvents"]


def test_busy_time_counts_kernels_apart_from_copies():
    """The trace summary's busy time is the union of the kernels' intervals
    (streams overlapping count once); memory copies and sets are summed
    apart, and host events count in neither."""
    from types import SimpleNamespace

    from bvc_tpu_torch.utils.profiling import busy_us

    def event(name, lo, hi, device=torch.autograd.DeviceType.CUDA):
        return SimpleNamespace(name=name, device_type=device,
                               time_range=SimpleNamespace(start=lo, end=hi))

    events = [event("gemm", 0, 10), event("flash_fwd", 5, 12), event("gemm", 20, 25),
              event("Memcpy HtoD (Pinned -> Device)", 8, 30), event("Memset (Device)", 40, 41),
              event("aten::mm", 0, 100, torch.autograd.DeviceType.CPU)]
    assert busy_us(events) == (17.0, 23.0)
