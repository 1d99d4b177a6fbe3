"""Communication accounting of the port (``bvc_tpu_torch/parallel/analysis.py``)
held to the contract ``tests/test_collectives_analysis.py`` pins on the JAX
package, case by case, on gloo ranks on the CPU at that file's ``_CFG``:

- the ring estimates agree with JAX's ``CollectiveOp`` exactly, and a
  report's ``summary()`` has JAX's keys and values;
- pure DP all-reduces exactly the gradient bytes (JAX's ``tree_bytes`` of
  the same parameters, rel 0.01) and gathers, scatters and broadcasts
  nothing; under ``grad_accum=4`` the same bytes, and no collective of
  1024 bytes or more in the loop;
- ``zero1`` reduces the gradient volume and adds about one parameter
  volume, as a broadcast (JAX: an all-gather); ``fsdp`` gathers and
  scatters (its gathers repeat in the accumulation loop by design; beside
  ``model`` at ``data=1`` it is HSDP's all-reduce over ``model``); ``tp``
  reduces over ``model`` groups;
- the seq step is the ring's hops (each byte the ring must send, counted
  from the config) plus one gradient all-reduce; the pipe step is stage
  hops (counted from the config) plus gradient reductions within JAX's
  bounds, with no gathers;
- ``comm_report`` leaves the state bit-equal; an unrecorded collective
  raises; the recorder puts torch's functions back; the CLI prints JAX's
  keys.
"""

import json

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from bvc_tpu.models import videomae as jax_videomae
from bvc_tpu.parallel.analysis import CollectiveOp as JaxOp
from bvc_tpu.parallel.analysis import CommReport as JaxReport
from bvc_tpu.parallel.analysis import tree_bytes as jax_tree_bytes
from bvc_tpu.utils.config import ModelConfig as JaxModelConfig
from bvc_tpu_torch.cli import analyze_collectives
from bvc_tpu_torch.models.convert import videomae_pretrain_from_jax_params
from bvc_tpu_torch.parallel.analysis import (CollectiveOp, CommReport, UnrecordedCollective,
                                             comm_report, record_collectives, tree_bytes)
from bvc_tpu_torch.utils.config import ModelConfig
from torch_ranks import run_ranks

_CFG = dict(image_size=32, patch_size=8, num_frames=4, tubelet_size=2, hidden_size=32,
            depth=2, num_heads=4, decoder_hidden_size=16, decoder_depth=1,
            decoder_num_heads=2, dtype="float32")
_PIPE = dict(depth=4, decoder_depth=2)
_BIG = 1024
MASK = dict(sampler="tube", mask_ratio=0.75)
OPTIM = dict(name="sgd", lr=0.05, momentum=0.9)
B, M = 8, 2  # clips a step (global), pipe microbatches
# (name, mesh, kind, param_sharding, grad_accum) at world 2
RUNS2 = [("dp", {"data": 2}, "step", "replicated", 1),
         ("dp_accum4", {"data": 2}, "step", "replicated", 4),
         ("zero1", {"data": 1, "model": 2}, "step", "zero1", 1),
         ("zero1_data2", {"data": 2}, "step", "zero1", 1),
         ("fsdp", {"data": 2}, "step", "fsdp", 1),
         ("fsdp_accum2", {"data": 2}, "step", "fsdp", 2),
         ("fsdp_model2", {"data": 1, "model": 2}, "step", "fsdp", 1),
         ("tp", {"data": 1, "model": 2}, "step", "tp", 1),
         ("seq", {"data": 1, "seq": 2}, "seq", "replicated", 1)]
RUNS4 = [("pipe", {"data": 2, "pipe": 2}, "pipe", "replicated", 1)]


def _jax_params(**fields):
    cfg = JaxModelConfig(**{**_CFG, **fields})
    tree = jax_videomae.init_params(jax.random.PRNGKey(0), cfg)
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def params():
    return {"default": _jax_params(), "pipe": _jax_params(**_PIPE)}


def _spec(params, runs):
    clips = np.random.default_rng(0).integers(0, 255, (B, 4, 32, 32, 3), dtype=np.uint8)
    weights = {name: videomae_pretrain_from_jax_params(tree, ModelConfig(
        **{**_CFG, **(_PIPE if name == "pipe" else {})})) for name, tree in params.items()}
    return {"model": _CFG, "overrides": {"pipe": _PIPE}, "mask": MASK, "optim": OPTIM,
            "weights": weights, "clips": {"default": clips}, "microbatches": M, "runs": runs}


@pytest.fixture(scope="module")
def world2(params, tmp_path_factory):
    ranks = run_ranks("reports", _spec(params, RUNS2), tmp_path_factory.mktemp("comm2"), 2,
                      module="torch_comm_ranks", timeout=240)
    return [{k: (CommReport([CollectiveOp(**op) for op in v["ops"]]), v) for k, v in r.items()}
            for r in ranks]


@pytest.fixture(scope="module")
def world4(params, tmp_path_factory):
    ranks = run_ranks("reports", _spec(params, RUNS4), tmp_path_factory.mktemp("comm4"), 4,
                      module="torch_comm_ranks", timeout=240)
    return [{k: (CommReport([CollectiveOp(**op) for op in v["ops"]]), v) for k, v in r.items()}
            for r in ranks]


# ------------------------------------------------------------- estimates


@pytest.mark.parametrize("kind,payload,group", [
    ("all-reduce", 1000, 8), ("all-gather", 1000, 4), ("reduce-scatter", 125, 8),
    ("all-reduce", 1000, 1), ("collective-permute", 640, 1)])
def test_ring_estimates_equal_jax(kind, payload, group):
    assert (CollectiveOp(kind, payload, group).ring_bytes_per_chip
            == JaxOp(kind, payload, group).ring_bytes_per_chip)


def test_broadcast_estimate():
    # every rank but the root receives the payload once, averaged over the group
    assert CollectiveOp("broadcast", 1000, 4).ring_bytes_per_chip == pytest.approx(750.0)
    assert CollectiveOp("broadcast", 1000, 1).ring_bytes_per_chip == 0.0


def test_summary_has_jax_keys_and_values():
    ops = [("all-reduce", 4096, 2, False), ("all-gather", 2048, 4, True),
           ("reduce-scatter", 512, 4, False), ("collective-permute", 640, 2, True)]
    port = CommReport([CollectiveOp(k, p, g, in_loop=loop) for k, p, g, loop in ops])
    ref = JaxReport([JaxOp(k, p, g, in_loop=loop) for k, p, g, loop in ops])
    assert port.summary() == ref.summary()
    assert port.bytes_for("all-gather", 1024) == ref.bytes_for("all-gather", 1024)
    assert port.count_for("all-reduce") == ref.count_for("all-reduce")
    assert len(port.loop_ops) == len(ref.loop_ops) == 2


def test_tree_bytes_agrees_with_jax(params):
    tree = params["default"]
    cfg = ModelConfig(**_CFG)
    sd = videomae_pretrain_from_jax_params(tree, cfg)
    from bvc_tpu_torch.models.videomae import VideoMAEPretrain

    model = VideoMAEPretrain(cfg)
    model.load_state_dict(sd)
    want = jax_tree_bytes(tree)
    assert tree_bytes(tree) == want  # JAX's own tree, as numpy arrays
    assert tree_bytes(model) == pytest.approx(want, rel=0.01)
    assert tree_bytes(list(model.parameters())) == tree_bytes(model)
    assert tree_bytes({n: p for n, p in model.named_parameters()}) == tree_bytes(model)


# ------------------------------------------------------ the JAX contract


def test_dp_allreduces_grad_volume_and_gathers_nothing(world2, params):
    report, _ = world2[0]["dp"]
    ar = report.bytes_for("all-reduce", min_payload=_BIG)
    assert ar == pytest.approx(jax_tree_bytes(params["default"]), rel=0.01)
    for kind in ("all-gather", "reduce-scatter", "broadcast"):
        assert report.bytes_for(kind, min_payload=_BIG) == 0, kind
    assert all(op.line.startswith("ddp bucket") for op in report.ops
               if op.kind == "all-reduce" and op.payload_bytes >= _BIG)


def test_grad_accum_keeps_collectives_out_of_the_loop(world2, params):
    report, _ = world2[0]["dp_accum4"]
    big_loop_ops = [op for op in report.loop_ops if op.payload_bytes >= _BIG]
    assert big_loop_ops == [], [(o.kind, o.payload_bytes, o.line) for o in big_loop_ops]
    ar = report.bytes_for("all-reduce", min_payload=_BIG)
    assert ar == pytest.approx(jax_tree_bytes(params["default"]), rel=0.01)
    # the loop marking is live: FSDP2's gathers of the first microbatch are in it
    fsdp, _ = world2[0]["fsdp_accum2"]
    assert fsdp.bytes_for("all-gather", _BIG) > 0
    assert {op.kind for op in fsdp.loop_ops if op.payload_bytes >= _BIG} == {"all-gather"}
    assert 0 < len(fsdp.loop_ops) < fsdp.count_for("all-gather")


@pytest.mark.parametrize("run", ["zero1", "zero1_data2"])
def test_zero1_adds_one_param_volume(world2, params, run):
    report, rec = world2[0][run]
    grad_bytes = jax_tree_bytes(params["default"])
    ar = report.bytes_for("all-reduce", min_payload=_BIG)
    rs = report.bytes_for("reduce-scatter", min_payload=_BIG)
    assert ar + rs * 8 >= grad_bytes * 0.9
    # the updated parameters from their owners: a broadcast, where JAX gathers
    bc = sum(op.payload_bytes for op in report.ops if op.kind == "broadcast")
    assert grad_bytes * 0.5 <= bc <= grad_bytes * 1.5
    assert bc == rec["held_bytes"]
    assert report.bytes_for("all-gather", min_payload=_BIG) == 0


def test_fsdp_gathers_params_and_scatters_grads(world2, params):
    report, _ = world2[0]["fsdp"]
    assert report.bytes_for("all-gather", min_payload=_BIG) > 0
    rs = report.bytes_for("reduce-scatter", min_payload=_BIG)
    ar = report.bytes_for("all-reduce", min_payload=_BIG)
    assert rs > 0 or ar > 0
    # each rank's shards of every gradient (padded to equal rows)
    assert rs * 2 >= jax_tree_bytes(params["default"])


def test_fsdp_beside_model_is_hsdp(world2, params):
    report, _ = world2[0]["fsdp_model2"]
    model_ops = [op for op in report.ops if op.kind == "all-reduce" and op.group_size == 2
                 and op.payload_bytes >= _BIG]
    assert sum(op.payload_bytes for op in model_ops) == pytest.approx(
        jax_tree_bytes(params["default"]), rel=0.01)


def test_tp_collectives_run_over_model_groups(world2):
    report, rec = world2[0]["tp"]
    model_ops = [op for op in report.ops if op.group_size == 2 and op.payload_bytes >= _BIG]
    assert model_ops, "TP must reduce activations over the model axis"
    # the gradient reduction over the data axis (one rank): the rank's parts
    data_ops = [op for op in report.ops if op.line.startswith("ddp bucket")]
    assert data_ops and all(op.group_size == 1 for op in data_ops)
    assert sum(op.payload_bytes for op in data_ops) == rec["held_bytes"]


def _ring_sends(cfg: ModelConfig, S: int, b: int, mask_ratio: float) -> int:
    """Bytes a rank of a seq ring of S sends a step: per attention layer,
    the K and V blocks S - 1 times forward and S - 1 times backward, and the
    f32 dK and dV S times."""
    item = 4 if cfg.dtype == "float32" else 2
    space = (cfg.image_size // cfg.patch_size) ** 2
    sheets = cfg.num_frames // cfg.tubelet_size // S
    visible = (space - int(mask_ratio * space)) * sheets
    total = 0
    for n, width, layers in ((visible, cfg.hidden_size, cfg.depth),
                             (space * sheets, cfg.decoder_hidden_size, cfg.decoder_depth)):
        block = b * n * width
        total += layers * (2 * (S - 1) * 2 * block * item + S * 2 * block * 4)
    return total


def test_seq_step_is_ring_hops_plus_one_grad_allreduce(world2, params):
    for report, _ in (r["seq"] for r in world2):
        assert report.bytes_for("all-reduce", min_payload=_BIG) == pytest.approx(
            jax_tree_bytes(params["default"]), rel=0.01)
        pp = [op for op in report.ops if op.kind == "collective-permute"]
        assert pp, "ring attention must send over the ring"
        for op in pp:
            assert op.ring_bytes_per_chip == float(op.payload_bytes)
        assert sum(op.payload_bytes for op in pp) == _ring_sends(
            ModelConfig(**_CFG), 2, B, MASK["mask_ratio"])
        assert report.bytes_for("all-gather", min_payload=_BIG) == 0
        assert report.bytes_for("reduce-scatter", min_payload=_BIG) == 0


def test_pipe_step_is_stage_hops_plus_grad_reductions(world4, params):
    tree = params["pipe"]
    blocks = {"encoder": tree["encoder"], "decoder": tree["decoder"]}
    stage_bytes = jax_tree_bytes(blocks) // 2
    cfg = ModelConfig(**{**_CFG, **_PIPE})
    space = (cfg.image_size // cfg.patch_size) ** 2
    visible = cfg.seq_len - int(MASK["mask_ratio"] * space) * cfg.num_time_steps
    b = B // 2  # a data block
    hops = b * (2 * visible * cfg.hidden_size + cfg.seq_len * cfg.decoder_hidden_size) * 4
    for report, rec in (r["pipe"] for r in world4):
        pp = [op for op in report.ops if op.kind == "collective-permute"]
        assert pp, "the GPipe schedule must send between stages"
        for op in pp:
            assert op.ring_bytes_per_chip == float(op.payload_bytes)
        # stage 0 sends the activations on and the relay's gradient back;
        # stage 1 the relay forward and the gradients back: the same bytes
        assert sum(op.payload_bytes for op in pp) == hops
        ar = report.bytes_for("all-reduce", min_payload=_BIG)
        assert stage_bytes <= ar <= 3 * jax_tree_bytes(tree)
        # the edge over pipe, then the stage's whole gradients over data
        assert ar == rec["edge_bytes"] + rec["held_bytes"]
        assert report.bytes_for("all-gather", min_payload=_BIG) == 0
        assert report.bytes_for("reduce-scatter", min_payload=_BIG) == 0


@pytest.mark.parametrize("run", [r[0] for r in RUNS2] + [r[0] for r in RUNS4])
def test_comm_report_leaves_the_state_bit_equal(world2, world4, run):
    ranks = world4 if run == "pipe" else world2
    for r in ranks:
        report, rec = r[run]
        assert rec["unchanged"], run
        assert report.ops and all(op.computation.startswith("make_") for op in report.ops)


# ------------------------------------------------------------ the recorder


def test_unknown_collective_raises_and_torch_comes_back():
    own = {name: getattr(dist, name) for name in ("all_reduce", "reduce", "batch_isend_irecv",
                                                  "P2POp", "isend")}
    with record_collectives() as ops:
        assert dist.all_reduce is not own["all_reduce"]
        with pytest.raises(UnrecordedCollective, match="reduce"):
            dist.reduce(torch.zeros(4), 0)
    assert ops == []
    assert {name: getattr(dist, name) for name in own} == own


def test_comm_report_takes_recordings_not_hlo():
    ops = [CollectiveOp("all-reduce", 2048, 2)]
    assert comm_report(ops).ops == ops
    with pytest.raises(TypeError, match="no HLO"):
        comm_report("HloModule jit_step")


# ----------------------------------------------------------------- the CLI


@pytest.mark.parametrize("family", ["videomae", "jepa"])
def test_cli_prints_jax_keys(family, capsys):
    lines = analyze_collectives.main(["--n", "2", "--device", "cpu", "--tiny", "--family",
                                      family, "--timeout", "200"])
    rows = [json.loads(line) for line in lines if line.startswith("{")]
    jax_keys = {"layout", "param_bytes", "by_kind", "total_payload_bytes",
                "ring_bytes_per_chip", "large_collectives_in_scan"}
    want = ["dp", "dp+accum4", "fsdp", "tp2xdp1"] + (["dp1xpipe2"] if family == "videomae"
                                                      else [])
    assert [r["layout"] for r in rows] == want
    for r in rows:
        assert set(r) == jax_keys
        assert r["large_collectives_in_scan"] == 0
    assert rows[0]["by_kind"]["all-reduce"]["payload_bytes"] >= rows[0]["param_bytes"]
    skipped = [line for line in lines if line.startswith("skipped")]
    assert skipped == (["skipped dp0xseq4: 2 ranks cannot hold it"] if family == "videomae"
                       else [])
    assert "| layout | all-reduce | all-gather | reduce-scatter | ppermute |" in "\n".join(lines)
    assert capsys.readouterr().out.splitlines() == lines


def test_cli_refuses_the_cpu_unless_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        analyze_collectives.main(["--n", "2"])
