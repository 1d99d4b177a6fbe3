"""The port's serving export (``bvc_tpu_torch.serving``) against the JAX
package's own artifacts: ``export_embed`` -> ``save_artifact`` ->
``load_artifact`` on both sides from the same weights (carried by
``models/convert.py``), the same uint8 clips made with numpy.

Tolerances: VideoMAE in f32, the port's extraction limit against JAX
(``tests/test_torch_extract.py``: ``atol = 1e-4 * max|ref| + 1e-5``); JEPA
W8A8, per-row cosine >= 0.99999 to JAX (``tests/test_torch_w8a8_embed.py``);
SimCLR, ``tests/test_torch_resnet.py``'s rtol 1e-4 / atol 1e-5.  Each
artifact also against the port's direct embed on the same weights within
1e-6 (the same aten operators run; read: 0).  With the flash route forced
on the CPU the program holds the kernels' operators (one ``flash_fwd`` a
block, two ``gemm_s8`` a block in W8A8) and still matches.  A loaded
artifact needs no model module (checked in a subprocess), a pinned one
refuses another batch, and the CLI takes JAX's flags.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvc_tpu.cli import export_serving as jax_cli
from bvc_tpu.models import jepa as jax_jepa
from bvc_tpu.models import resnet as jax_resnet
from bvc_tpu.models import videomae as jax_videomae
from bvc_tpu.models.torch_interop import jepa_encoder_to_reference
from bvc_tpu.models.vit import VIT_DIMS
from bvc_tpu.serving import export as jax_serving
from bvc_tpu.utils.config import ModelConfig as JaxModelConfig
from bvc_tpu_torch.cli import export_serving
from bvc_tpu_torch.models.convert import (jepa_encoder_from_jax_params, resnet_from_jax_params,
                                          videomae_from_jax_params)
from bvc_tpu_torch.models.jepa import JEPAEncoder
from bvc_tpu_torch.models.resnet import ResNet
from bvc_tpu_torch.models.videomae import VideoMAEEncoder
from bvc_tpu_torch.ops import attention
from bvc_tpu_torch.ops.quant import QuantLinear, quantize_encoder
from bvc_tpu_torch.serving import export_embed, load_artifact, save_artifact
from bvc_tpu_torch.serving.export import kernel_ops
from bvc_tpu_torch.utils.config import ModelConfig

REPO = Path(__file__).resolve().parent.parent
# tests/test_serving.py's configurations
VIDEOMAE = dict(image_size=32, patch_size=8, num_frames=4, tubelet_size=2, hidden_size=32,
                depth=2, num_heads=4, decoder_hidden_size=16, decoder_depth=1,
                decoder_num_heads=2, dtype="float32")
JEPA = dict(family="jepa", image_size=16, patch_size=8, num_frames=2, tubelet_size=1,
            hidden_size=32, depth=2, num_heads=4, dtype="float32")
SIMCLR = dict(family="simclr", architecture="resnet18", image_size=32, num_frames=2,
              tubelet_size=1)
COSINE_TO_JAX = 0.99999
SIMCLR_RTOL, SIMCLR_ATOL = 1e-4, 1e-5
DIRECT_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clips(b: int, shape: tuple, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (b, *shape), dtype=np.uint8)


def _cos(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _jax_artifact(tmp_path, family, params, jcfg, **kw):
    exported, leaves, meta = jax_serving.export_embed(family, params, jcfg, **kw)
    return jax_serving.load_artifact(
        jax_serving.save_artifact(str(tmp_path / "jax"), exported, leaves, meta))


def _port_artifact(tmp_path, family, model, cfg, **kw):
    exported, meta = export_embed(family, model, cfg, device="cpu", **kw)
    return load_artifact(save_artifact(tmp_path / "port", exported, meta), device="cpu"), exported


def _videomae():
    jcfg = JaxModelConfig(**VIDEOMAE)
    tree = jax.tree_util.tree_map(np.asarray, jax_videomae.init_params(jax.random.PRNGKey(0),
                                                                       jcfg))
    model = VideoMAEEncoder(ModelConfig(**VIDEOMAE))
    model.load_state_dict(videomae_from_jax_params(tree, model.cfg))
    return jcfg, tree, model


def _jepa():
    jcfg = JaxModelConfig(**JEPA)
    tree = jax.tree_util.tree_map(np.asarray, jax_jepa.init_encoder_params(
        jax.random.PRNGKey(0), jcfg))
    model = JEPAEncoder(ModelConfig(**JEPA))
    model.load_state_dict(jepa_encoder_from_jax_params(tree, model.cfg))
    return jcfg, tree, model


def _direct(model, video, quantize=False) -> np.ndarray:
    with torch.no_grad():
        model = quantize_encoder(model) if quantize else model
        return model.eval().embed(torch.from_numpy(video)).numpy()


@pytest.mark.parametrize("route", ["auto", "flash"])
def test_videomae_polymorphic_matches_jax_artifact(tmp_path, monkeypatch, route):
    jcfg, tree, model = _videomae()
    if route == "flash":  # the kernels' operators in the graph, their plain versions run
        monkeypatch.setattr(attention, "attention_route", lambda *a: "flash")
    fn, exported = _port_artifact(tmp_path, "videomae", model, model.cfg)
    monkeypatch.undo()
    assert kernel_ops(exported) == ({"flash_fwd": 2} if route == "flash" else {})
    jfn = _jax_artifact(tmp_path, "videomae", tree, jcfg)
    for b in (1, 2, 5):
        video = _clips(b, (4, 32, 32, 3), seed=b)
        got, want = fn(video), jfn(video)
        assert got.shape == (b, 32) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max() + 1e-5)
        np.testing.assert_allclose(got, _direct(model, video), rtol=0, atol=DIRECT_ATOL)
    assert fn.feature_dim == 32
    assert fn.meta["batch"] == "polymorphic" and fn.meta["platforms"] == ["cpu"]
    assert fn.meta["n_leaves"] == len(model.state_dict()) + 1  # + the position table


@pytest.mark.parametrize("route", ["auto", "flash"])
def test_jepa_int8_matches_jax_artifact(tmp_path, monkeypatch, route):
    jcfg, tree, model = _jepa()
    if route == "flash":
        monkeypatch.setattr(attention, "attention_route", lambda *a: "flash")
    fn, exported = _port_artifact(tmp_path, "jepa", model, model.cfg, quantize="int8")
    monkeypatch.undo()
    want_ops = {"gemm_s8": 4, **({"flash_fwd": 2} if route == "flash" else {})}
    assert kernel_ops(exported) == want_ops
    assert not any(isinstance(m, QuantLinear) for m in model.modules())  # the caller's model
    jfn = _jax_artifact(tmp_path, "jepa", tree, jcfg, quantize="int8")
    video = _clips(3, (2, 16, 16, 3), seed=0)
    got, want = fn(video), jfn(video)
    cos = _cos(got, want)
    assert cos.min() >= COSINE_TO_JAX, cos
    np.testing.assert_allclose(got, _direct(model, video, quantize=True), rtol=0,
                               atol=DIRECT_ATOL)
    assert fn.meta["quantize"] == "int8"


def test_simclr_last_frame_matches_jax_artifact(tmp_path):
    params, stats = jax.tree_util.tree_map(
        np.asarray, jax_resnet.init_params(jax.random.PRNGKey(0), "resnet18"))
    model = ResNet("resnet18")
    model.load_state_dict(resnet_from_jax_params(params, stats, "resnet18"))
    fn, exported = _port_artifact(tmp_path, "simclr", model, ModelConfig(**SIMCLR))
    assert not kernel_ops(exported)
    jfn = _jax_artifact(tmp_path, "simclr", {"params": params, "stats": stats},
                        JaxModelConfig(**SIMCLR))
    video = _clips(2, (2, 32, 32, 3), seed=1)
    got = fn(video)
    assert got.shape == (2, 512) and fn.feature_dim == 512
    np.testing.assert_allclose(got, jfn(video), rtol=SIMCLR_RTOL, atol=SIMCLR_ATOL)
    with torch.no_grad():
        frames = (torch.from_numpy(video[:, -1:]).float() * (1.0 / 255.0) - 0.5) * 4.0
        direct = model.eval().embed(frames).numpy()
    np.testing.assert_allclose(got, direct, rtol=0, atol=DIRECT_ATOL)


def test_pinned_batch_and_rejections(tmp_path):
    _, _, model = _videomae()
    exported, meta = export_embed("videomae", model, model.cfg, batch=3, device="cpu")
    assert meta["batch"] == 3
    fn = load_artifact(save_artifact(tmp_path / "art", exported, meta), device="cpu")
    video = _clips(3, (4, 32, 32, 3), seed=0)
    assert fn(video).shape == (3, 32)
    with pytest.raises(Exception):  # a pinned artifact at another batch
        fn(video[:2])
    with pytest.raises(ValueError, match="quantize"):
        export_embed("videomae", model, model.cfg, quantize="fp8", device="cpu")
    with pytest.raises(ValueError, match="ViT"):
        export_embed("simclr", ResNet("resnet18"), ModelConfig(**SIMCLR), quantize="int8",
                     device="cpu")
    with pytest.raises(ValueError, match="one device"):
        load_artifact(tmp_path / "art", device="cuda")


def test_load_needs_no_model_module(tmp_path, monkeypatch):
    """A fresh process loads and calls the artifact (with the flash and
    W8A8 operators in its graph) importing ``bvc_tpu_torch.serving`` only;
    no ``bvc_tpu_torch.models`` module is imported."""
    _, _, model = _jepa()
    monkeypatch.setattr(attention, "attention_route", lambda *a: "flash")
    exported, meta = export_embed("jepa", model, model.cfg, quantize="int8", device="cpu")
    monkeypatch.undo()
    path = save_artifact(tmp_path / "art", exported, meta)
    video = _clips(2, (2, 16, 16, 3), seed=4)
    np.save(tmp_path / "video.npy", video)
    code = (
        "import sys, numpy as np\n"
        "from bvc_tpu_torch.serving import load_artifact\n"
        f"fn = load_artifact({str(path)!r}, device='cpu')\n"
        f"np.save({str(tmp_path / 'out.npy')!r}, fn(np.load({str(tmp_path / 'video.npy')!r})))\n"
        "print(sorted(k for k in sys.modules if k.startswith('bvc_tpu_torch.models')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"
    np.testing.assert_allclose(np.load(tmp_path / "out.npy"),
                               _direct(model, video, quantize=True), rtol=0, atol=DIRECT_ATOL)


def test_cli_exports_a_jax_written_checkpoint(tmp_path):
    """A ``.pth.tar`` of a JAX ``vit_tiny`` JEPA encoder in the reference
    layout (what ``bvc_tpu.models.torch_interop`` writes), exported by the
    port's CLI at its bf16 compute dtype, against JAX's ``jepa.embed`` in
    f32 at JAX's CLI limits (``tests/test_serving.py``)."""
    dim, depth, heads = VIT_DIMS["vit_tiny"]
    jcfg = JaxModelConfig(family="jepa", architecture="vit_tiny", image_size=32, num_frames=2,
                          tubelet_size=1, hidden_size=dim, depth=depth, num_heads=heads)
    params = jax_jepa.init_encoder_params(jax.random.PRNGKey(3), jcfg)
    ckpt = tmp_path / "model_dev_1_g0_default_0_0.pth.tar"
    torch.save({"encoder": {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
                            jepa_encoder_to_reference(params, jcfg).items()}}, ckpt)
    out = tmp_path / "artifact"
    path = export_serving.main(["-init_checkpoint_path", str(ckpt), "-out", str(out),
                                "--family", "jepa", "--architecture", "tiny", "--image_size",
                                "32", "--num_frames", "2", "--tubelet_size", "1"], device="cpu")
    meta = json.loads((out / "meta.json").read_text())
    assert path == str(out) and meta["checkpoint"] == str(ckpt)
    assert meta["platforms"] == ["cpu"] and meta["architecture"] == "vit_tiny"
    fn = load_artifact(out, device="cpu")
    video = _clips(2, (2, 32, 32, 3), seed=0)
    got = fn(video)
    ref = np.asarray(jax_jepa.embed(params, jnp.asarray(video), jcfg))
    np.testing.assert_allclose(got, ref, atol=2e-2)
    assert _cos(got, ref).min() > 0.9999


def test_cli_flags_equal_jax():
    def flags(parser):
        return {tuple(a.option_strings): (a.type, a.default, a.required)
                for a in parser._actions if a.option_strings != ["-h", "--help"]}

    assert flags(export_serving.build_parser()) == flags(jax_cli.build_parser())
    args = export_serving.build_parser().parse_args(
        ["-init_checkpoint_path", "na", "-out", "/tmp/x", "--quantize", "int8", "--batch", "4",
         "--platforms", "cpu"])
    assert args.quantize == "int8" and args.batch == 4


@pytest.mark.parametrize("platforms,device,want", [("", None, None), ("", "cpu", "cpu"),
                                                   ("cpu", None, "cpu"), ("cuda", None, "cuda"),
                                                   (" cpu ", "cpu", "cpu")])
def test_platforms_name_one_device(platforms, device, want):
    assert export_serving.export_device(platforms, device) == want


@pytest.mark.parametrize("platforms,device", [("tpu", None), ("cuda,cpu", None),
                                              ("cpu", "cuda")])
def test_platforms_refused(platforms, device):
    with pytest.raises(ValueError, match="one device|contradicts"):
        export_serving.export_device(platforms, device)


def test_cli_random_model_from_seed(tmp_path):
    """``-init_checkpoint_path na``: a random SimCLR model from ``--seed``,
    pinned batch; the same seed gives the same artifact's embeddings."""
    outs = []
    for name in ("a", "b"):
        export_serving.main(["-init_checkpoint_path", "na", "-out", str(tmp_path / name),
                             "--family", "simclr", "--architecture", "resnet18",
                             "--image_size", "32", "--num_frames", "2", "--batch", "2",
                             "--seed", "5", "--platforms", "cpu"])
        outs.append(load_artifact(tmp_path / name, device="cpu")(_clips(2, (2, 32, 32, 3), 0)))
    np.testing.assert_array_equal(outs[0], outs[1])
    assert json.loads((tmp_path / "a" / "meta.json").read_text())["batch"] == 2
