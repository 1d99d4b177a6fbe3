"""The port's curriculum driver and its CLI against ``bvc_tpu``'s, without
training: stage plans and stage configs for every preset, curriculum and
condition; the emitted scripts; and the driver's wiring (the configs each
stage's trainer gets, the checkpoint chain, the extraction sweep's calls and
the manifest), with both packages' trainers and extraction replaced by the
same recorders.

Tolerance: none.  Plans, configs (``dataclasses.asdict``) and manifests are
equal exactly; a script equals JAX's after exactly the substitutions of
``SUBSTITUTIONS`` and no others.
"""

import dataclasses
import json
import re
import shlex
import subprocess

import pytest
import torch

from bvc_tpu.cli import run_curriculum as jax_cli
from bvc_tpu.curriculum import driver as jax_driver
from bvc_tpu.curriculum import presets as jax_presets
from bvc_tpu.utils.config import TrainConfig as JaxTrainConfig
from bvc_tpu_torch.cli import compute_embeddings, pretrain_jepa, pretrain_simclr, pretrain_videomae
from bvc_tpu_torch.cli import run_curriculum as cli
from bvc_tpu_torch.curriculum import driver
from bvc_tpu_torch.curriculum.presets import (CONDITION_FRAME_OVERRIDES, CURRICULA,
                                              FAMILY_PRESETS, apply_overrides)
from bvc_tpu_torch.utils.config import TrainConfig
from torch_port_config import jax_comparable, without_port_only

CONDITIONS = ["default", "MatchedSpatial", "MatchedSpatioTemporal", "MatchedTemporal", "static"]

# JAX's script -> the port's: its CLIs, its provenance line, its checkpoint
# files, and one GPU on the reference cluster's gpu partition
SUBSTITUTIONS = [
    ("python -m bvc_tpu.cli.", "python -m bvc_tpu_torch.cli."),
    ("generated by bvc_tpu.curriculum.emit_script",
     "generated by bvc_tpu_torch.curriculum.emit_script"),
    (re.compile(r'^(INIT="\$SAVEDIR/model_[^"]+)\.ckpt"$', re.M), r'\1.pth.tar"'),
    ("#SBATCH --partition=tpu\n", "#SBATCH --partition=gpu\n#SBATCH --gres=gpu:1\n"),
]
PORT_CLIS = {"pretrain_videomae": pretrain_videomae, "pretrain_jepa": pretrain_jepa,
             "pretrain_simclr": pretrain_simclr, "compute_embeddings": compute_embeddings}


def to_port(script: str) -> str:
    for old, new in SUBSTITUTIONS:
        script = old.sub(new, script) if isinstance(old, re.Pattern) else script.replace(old, new)
    return script


def _base(Cfg, condition="default"):
    base = Cfg(savedir="/out", seed=101)
    base.data.condition = condition
    return base


# --- (a) plans and configs ---------------------------------------------------


def test_presets_are_the_jax_presets():
    assert CURRICULA == jax_presets.CURRICULA
    assert CONDITION_FRAME_OVERRIDES == jax_presets.CONDITION_FRAME_OVERRIDES
    assert FAMILY_PRESETS.keys() == jax_presets.FAMILY_PRESETS.keys()
    for name, preset in FAMILY_PRESETS.items():
        assert dataclasses.asdict(preset) == dataclasses.asdict(
            jax_presets.FAMILY_PRESETS[name]), name


@pytest.mark.parametrize("curriculum", sorted(CURRICULA))
@pytest.mark.parametrize("preset", sorted(FAMILY_PRESETS))
def test_stage_plan_and_config_match_jax(preset, curriculum):
    """Every condition, stages 1-3: the plan (run ids, folds, groups,
    overrides) and ``asdict`` of each stage's TrainConfig equal JAX's."""
    ours, theirs = FAMILY_PRESETS[preset], jax_presets.FAMILY_PRESETS[preset]
    for condition in CONDITIONS:
        for seed in (0, 101):
            plan = driver.stage_plan(curriculum, ours, seed, condition)
            assert plan == jax_driver.stage_plan(curriculum, theirs, seed, condition)
            assert [p["fold"] for p in plan] == [(seed + s) % 3 for s in (1, 2, 3)]
            for info in plan:
                cfg = driver.build_stage_config(ours, info, _base(TrainConfig, condition))
                jcfg = jax_driver.build_stage_config(theirs, info,
                                                     _base(JaxTrainConfig, condition))
                assert jax_comparable(dataclasses.asdict(cfg)) == dataclasses.asdict(jcfg), \
                    info["run_id"]


def test_apply_overrides_matches_jax():
    spec = "n_epoch=1,max_epoch_iters=3,n_trainsamples=64,batch_size=2,allow_overlap=y"
    for name, preset in FAMILY_PRESETS.items():
        assert dataclasses.asdict(apply_overrides(preset, spec)) == dataclasses.asdict(
            jax_presets.apply_overrides(jax_presets.FAMILY_PRESETS[name], spec))
    with pytest.raises(ValueError):
        apply_overrides(FAMILY_PRESETS["predictive"], "allow_overlap=maybe")
    with pytest.raises(AttributeError):
        apply_overrides(FAMILY_PRESETS["generative"], "nonexistent_field=1")
    assert FAMILY_PRESETS["generative"].n_epoch == 5  # the registry is untouched


# --- (b) scripts --------------------------------------------------------------


def _argv_of(command: str) -> tuple[str, list[str]]:
    """(CLI module name, argv) of one emitted ``python -m`` command."""
    toks = shlex.split(command.replace("\\\n", " "))
    assert toks[:2] == ["python", "-m"], command
    return toks[2].removeprefix("bvc_tpu_torch.cli."), toks[3:]


@pytest.mark.parametrize("sbatch", [False, True], ids=["plain", "sbatch"])
@pytest.mark.parametrize("preset", sorted(FAMILY_PRESETS))
def test_emit_script_matches_jax(preset, sbatch, tmp_path):
    """With and without extraction and ``--quantize int8``, and under a
    Matched* condition: JAX's script after ``SUBSTITUTIONS``; it passes
    ``bash -n``, and each command parses with the port's CLI."""
    cases = [dict(), dict(extract={"ssv2": "/data/ssv2", "ucf101": "$UCF_ROOT"}),
             dict(extract={"ssv2": "/data/ssv2"}, extract_quantize="int8"),
             dict(condition="MatchedSpatioTemporal", control_data_root="/pkls",
                  extract={"toybox": "/data/tb"})]
    for kw in cases:
        kw = dict(kw, sbatch=sbatch, preset_name=preset)
        ours = driver.emit_script("dev", FAMILY_PRESETS[preset], 7, **kw)
        theirs = jax_driver.emit_script("dev", jax_presets.FAMILY_PRESETS[preset], 7, **kw)
        assert ours == to_port(theirs), kw
        assert ours != theirs
        path = tmp_path / "s.sh"
        path.write_text(ours)
        assert subprocess.run(["bash", "-n", str(path)]).returncode == 0
        commands = [c for c in re.split(r"\n(?=python -m)", ours) if c.startswith("python -m")]
        assert len(commands) == 3 + len(kw.get("extract", {}))
        for command in commands:
            name, argv = _argv_of(command.split("\nINIT=")[0])
            PORT_CLIS[name].build_parser().parse_args(argv)
        assert ours.count(".pth.tar\"") == 3 and ".ckpt" not in ours
        assert ("#SBATCH --gres=gpu:1" in ours) == sbatch


def test_cli_flags_match_jax():
    """The port's CLI has JAX's flags with their types, defaults and
    choices, and one more: ``--pack_root`` (the live run's packed corpus)."""
    def flags(parser):
        return {a.option_strings[0]: (a.type, a.default, a.choices, a.required)
                for a in parser._actions if a.option_strings and a.dest != "help"}

    ours, theirs = flags(cli.build_parser()), flags(jax_cli.build_parser())
    assert ours.pop("--pack_root") == (str, "", None, False)
    assert ours == theirs


def test_emit_script_refuses_pack_root(tmp_path):
    """``--pack_root`` reaches the live run only: asked for with
    ``--emit_script`` it raises, and no script is written."""
    script = tmp_path / "run.sh"
    with pytest.raises(ValueError, match="--pack_root applies to the live run only"):
        cli.main(["-jpg_root", "/d", "-savedir", str(tmp_path), "--pack_root", "/p",
                  "--emit_script", str(script)], device="cpu")
    assert not script.exists()


def test_parse_extract_matches_jax():
    args = cli.build_parser().parse_args(
        ["-jpg_root", "/d", "-savedir", "/s", "--extract", "ssv2=/a, ucf101 = /b",
         "--frame_rate", "6", "--extract_batch_size", "16", "--extract_quantize", "int8"])
    jargs = jax_cli.build_parser().parse_args(
        ["-jpg_root", "/d", "-savedir", "/s", "--extract", "ssv2=/a, ucf101 = /b",
         "--frame_rate", "6", "--extract_batch_size", "16", "--extract_quantize", "int8"])
    assert cli._parse_extract(args) == jax_cli._parse_extract(jargs)
    assert cli._parse_extract(cli.build_parser().parse_args(["-jpg_root", "/d", "-savedir",
                                                             "/s"])) is None


@pytest.mark.parametrize("argv", [
    ["--preset", "generative", "--curriculum", "dev", "--seed", "101",
     "--extract", "ssv2=/data/ssv2"],
    ["--preset", "generative", "--seed", "7", "--sbatch", "y"],
    ["--preset", "generative", "--seed", "7", "--sbatch", "y", "--job_name", "j"],
    ["--preset", "predictive", "--extract", "ssv2=/data/ssv2", "--extract_quantize", "int8"],
    ["--preset", "contrastive", "--frame_rate", "6", "--extract_batch_size", "16",
     "--extract", "ssv2=/data/ssv2"],
    ["--preset", "generative", "--override", "n_epoch=1,batch_size=2"],
    ["--preset", "complexity_control", "--condition", "MatchedSpatioTemporal",
     "--control_data_root", "/pkls", "--extract", "ssv2=/data/ssv2"],
    ["--preset", "generative", "--condition", "static"],
    ["--preset", "predictive_unt", "--n_stages", "1"],
], ids=["dev-extract", "sbatch", "job_name", "int8", "contrastive", "override", "matched",
        "static", "predictive_unt"])
def test_cli_emit_script_matches_jax(argv, tmp_path, capsys):
    """``tests/test_curriculum_cli.py``'s CLI cases on the port's ``main``:
    the file it writes is JAX's after the substitutions."""
    common = ["-jpg_root", "/data/home view", "-savedir", "/out"]
    cli.main(common + argv + ["--emit_script", str(tmp_path / "ours.sh")])
    jax_cli.main(common + argv + ["--emit_script", str(tmp_path / "theirs.sh")])
    ours = (tmp_path / "ours.sh").read_text()
    assert ours == to_port((tmp_path / "theirs.sh").read_text())
    assert json.loads(capsys.readouterr().out.splitlines()[0]) == {
        "emitted": str(tmp_path / "ours.sh"), "stages": 3 if "--n_stages" not in argv else 1}
    assert subprocess.run(["bash", "-n", str(tmp_path / "ours.sh")]).returncode == 0


# --- (c) the driver's wiring --------------------------------------------------


class Recorder:
    """Stands in for a trainer: records each stage's config and returns a
    checkpoint named as the port's trainers name theirs."""

    def __init__(self):
        self.configs = []

    def __call__(self, cfg, **kw):
        assert set(kw) in ({"mesh"}, {"device"})
        self.configs.append(dataclasses.asdict(cfg))
        return {"checkpoint": f"{cfg.savedir}/model_{cfg.run_id}.pth.tar", "train_loss": 1.0}


class ExtractionRecorder:
    def __init__(self):
        self.calls = []

    def __call__(self, task, checkpoints, run_ids, model_cfg, family, base, where, logger):
        self.calls.append((task, list(checkpoints), list(run_ids),
                           dataclasses.asdict(model_cfg), family))
        return [{"ds_task": task["ds_task"], "phase": phase, "run_id": rid,
                 "csv": f"{base.savedir}/{phase}/embeddings_{rid}.csv"}
                for rid in run_ids for phase in ("train", "test")]


@pytest.mark.parametrize("preset", ["generative", "predictive", "contrastive",
                                    "complexity_control"])
def test_driver_wiring_matches_jax(preset, tmp_path, monkeypatch):
    """The same curriculum through both drivers: the stages' configs, the
    checkpoint chain from ``init_checkpoint_path``, the extraction sweep's
    calls (stage-0 baseline first) and the manifest are equal."""
    condition = "MatchedTemporal" if preset == "complexity_control" else "default"
    extraction = [{"ds_task": "ssv2", "vid_root": "/v", "frame_rate": 12, "batch_size": 4,
                   "quantize": "int8" if preset == "predictive" else "none"}]
    runs = {}
    for name, mod, Cfg, presets, kw in (
            ("port", driver, TrainConfig, FAMILY_PRESETS, {"device": "cpu"}),
            ("jax", jax_driver, JaxTrainConfig, jax_presets.FAMILY_PRESETS, {})):
        trainer, sweep = Recorder(), ExtractionRecorder()
        monkeypatch.setattr(mod, "_trainer_for", lambda family, t=trainer: t)
        monkeypatch.setattr(mod, "_run_extraction", sweep)
        base = Cfg(savedir=str(tmp_path / name), seed=5)
        base.data.jpg_root = "/corpus"
        results = mod.run_curriculum("adev", presets[preset], base, condition=condition,
                                     init_checkpoint_path="/warm/model_x.pth.tar",
                                     extraction=extraction, untrained_baseline=True, **kw)
        manifest = tmp_path / name / f"curriculum_adev_{condition}_5.json"
        runs[name] = (trainer.configs, sweep.calls, json.loads(manifest.read_text()), results)
    ours, theirs = runs["port"], runs["jax"]
    strip = (lambda x: json.loads(json.dumps(x).replace(str(tmp_path / "port"), "S")
                                  .replace(str(tmp_path / "jax"), "S")))
    assert strip([jax_comparable(c) for c in ours[0]]) == strip(theirs[0])
    assert strip([(*c[:3], without_port_only(c[3], "model"), c[4]) for c in ours[1]]) == \
        strip(theirs[1])
    assert strip(ours[2]) == strip(theirs[2])
    configs, calls, manifest, _ = ours
    chain = ["/warm/model_x.pth.tar"] + [s["checkpoint"] for s in manifest["stages"]]
    assert [c["init_checkpoint_path"] for c in configs] == chain[:3]
    assert manifest["final_checkpoint"] == chain[-1]
    assert set(manifest) == {"curriculum", "stages", "final_checkpoint", "extraction"}
    assert [c[2] for c in calls] == [["adev_0_na_%s_0_5" % condition],
                                     [s["run_id"] for s in manifest["stages"]]]
    assert calls[0][1] == ["na"] and calls[1][1] == chain[1:]


@pytest.mark.parametrize("field,value,flag,error,match", [
    ("mesh_shape", {"data": 2}, ["--mesh", "data=2"], ValueError, "needs 2 processes"),
    ("param_sharding", "sharded", ["--param_sharding", "sharded"], ValueError,
     "unknown param_sharding 'sharded'"),
    ("mesh_shape", {"data": 1, "seq": 2}, ["--mesh", "data=1,seq=2"], ValueError,
     "needs 2 processes"),
    ("mesh_shape", {"data": 1, "pipe": 2}, ["--mesh", "data=1,pipe=2"], ValueError,
     "needs 2 processes"),
], ids=["mesh_shape-value0", "param_sharding-value1", "seq", "pipe"])
def test_multi_gpu_layouts_raise(field, value, flag, error, match, tmp_path, monkeypatch):
    """A layout the run cannot take raises before any stage trains or
    extracts: ``data=2``, ``data=1,seq=2`` or ``data=1,pipe=2`` in one
    process (each needs two ranks; a ``seq`` mesh runs since slice 7c, see
    ``test_seq_mesh_reaches_every_stage_and_the_sweep``, a ``pipe`` mesh
    since slice 7d), and a sharding mode that does not exist (``zero1``,
    ``fsdp`` and ``tp`` run since slice 7b); so does the CLI."""
    monkeypatch.setattr(driver, "_trainer_for", lambda family: pytest.fail("trained"))
    base = TrainConfig(savedir=str(tmp_path))
    setattr(base, field, value)
    with pytest.raises(error, match=match):
        driver.run_curriculum("dev", "generative", base, extraction=[{}],
                              untrained_baseline=True, device="cpu")
    with pytest.raises(error, match=match):
        cli.main(["-jpg_root", "/d", "-savedir", str(tmp_path)] + flag, device="cpu")
    assert not any(tmp_path.iterdir())


def test_seq_mesh_reaches_every_stage_and_the_sweep(tmp_path, monkeypatch):
    """``--mesh data=1,seq=1`` (a ``seq`` mesh in one process) passes
    ``run_curriculum``'s check and reaches every stage's config and the
    sweep's, as the JAX package's ``run_curriculum`` passes its mesh on."""
    trainer, sweep, seen = Recorder(), ExtractionRecorder(), []

    def extraction(task, ckpts, rids, cfg, family, base, where, logger):
        seen.append(base.mesh_shape)
        return sweep(task, ckpts, rids, cfg, family, base, where, logger)

    monkeypatch.setattr(driver, "_trainer_for", lambda family: trainer)
    monkeypatch.setattr(driver, "_run_extraction", extraction)
    base = TrainConfig(savedir=str(tmp_path), seed=5)
    base.mesh_shape = {"data": 1, "seq": 1}
    driver.run_curriculum("dev", "generative", base, extraction=[{"ds_task": "ssv2",
                                                                  "vid_root": "/v"}],
                          device="cpu")
    assert [c["mesh_shape"] for c in trainer.configs] == [{"data": 1, "seq": 1}] * 3
    assert seen == [{"data": 1, "seq": 1}] and len(sweep.calls) == 1


def test_pipe_mesh_reaches_every_stage_and_the_sweep(tmp_path, monkeypatch):
    """``--mesh data=1,pipe=1`` (a ``pipe`` mesh in one process) passes
    ``run_curriculum``'s check and reaches every stage's config and the
    sweep's, as the JAX package's ``run_curriculum`` passes its mesh on (its
    sweep embeds data parallel, the stages of a data row as replicas)."""
    trainer, sweep, seen = Recorder(), ExtractionRecorder(), []

    def extraction(task, ckpts, rids, cfg, family, base, where, logger):
        seen.append(base.mesh_shape)
        return sweep(task, ckpts, rids, cfg, family, base, where, logger)

    monkeypatch.setattr(driver, "_trainer_for", lambda family: trainer)
    monkeypatch.setattr(driver, "_run_extraction", extraction)
    base = TrainConfig(savedir=str(tmp_path), seed=5)
    base.mesh_shape = {"data": 1, "pipe": 1}
    driver.run_curriculum("dev", "generative", base, extraction=[{"ds_task": "ssv2",
                                                                  "vid_root": "/v"}],
                          device="cpu")
    assert [c["mesh_shape"] for c in trainer.configs] == [{"data": 1, "pipe": 1}] * 3
    assert seen == [{"data": 1, "pipe": 1}] and len(sweep.calls) == 1
    base.param_sharding = "fsdp"
    with pytest.raises(ValueError, match="defines its own stage sharding"):
        driver.run_curriculum("dev", "generative", base, device="cpu")


def test_no_gpu_and_no_device_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(driver, "_trainer_for", lambda family: pytest.fail("trained"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["-jpg_root", "/d", "-savedir", str(tmp_path)])
    assert not any(tmp_path.iterdir())
