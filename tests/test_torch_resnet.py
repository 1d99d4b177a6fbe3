"""The port's ResNet (``bvc_tpu_torch.models.resnet``) against
``bvc_tpu.models.resnet``, from the same weights through
``resnet_from_jax_params``, and its export layout against
``bvc_tpu.models.torch_interop.resnet_to_torch_state_dict``.

Tolerances: the f32 forward rtol 1e-4, atol 1e-5 and the new running
statistics atol 1e-6, or twice the JAX package's own distance from a plain
f64 evaluation of the same network where that is larger (both packages
accumulate in f32 in other orders, and train-mode BatchNorm over a few
positions amplifies it: JAX's ResNet-50 at 48 px misses f64 by about 3e-4
in its pooled features and 1.6e-4 in its running statistics).  That f64
evaluation (``plain_f64_forward``) is written here on the JAX package's
parameter tree with ``torch.nn.functional`` alone, not with the port's
model, and the port's own network run in f64 must meet it within 1e-9 of
the output's scale: a fault in the port's structure (a stride on the wrong
convolution, a missing projection) shows there however large the f32
limit is.  The export layout bit for bit; bf16 forwards in eval mode
cosine >= 0.999 per row (the head's bias rounds at another place,
``F.linear`` adds it inside the product; train mode over 32-pixel inputs
normalises ResNet-50's last stage over 4 positions, where bf16 rounding
decides the output in either package).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bvc_tpu.models import resnet as jax_resnet
from bvc_tpu.models.torch_interop import resnet_to_torch_state_dict
from bvc_tpu_torch.models import resnet
from bvc_tpu_torch.models.convert import (resnet_from_jax_params,
                                          resnet_from_torchvision_state_dict,
                                          resnet_to_torchvision_state_dict)

RTOL, ATOL, STATS_ATOL = 1e-4, 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_weights(arch: str, head_dim: int = 32, seed: int = 0):
    """JAX init, with BN affine and running statistics moved off their
    init values so that eval mode and the affine are exercised."""
    params, stats = jax.tree_util.tree_map(
        np.asarray, jax_resnet.init_params(jax.random.PRNGKey(seed), arch, head_dim))
    rng = np.random.default_rng(seed)

    def bn_params(path, x):
        names = [getattr(k, "key", None) for k in path]
        if "scale" in names:
            return (x * rng.uniform(0.8, 1.2, x.shape)).astype(np.float32)
        if "bias" in names and "head" not in names:
            return (x + rng.normal(0, 0.1, x.shape)).astype(np.float32)
        return x

    def bn_stats(path, x):
        if getattr(path[-1], "key", None) == "mean":
            return rng.normal(0, 0.1, x.shape).astype(np.float32)
        return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)

    return (jax.tree_util.tree_map_with_path(bn_params, params),
            jax.tree_util.tree_map_with_path(bn_stats, stats))


def port_model(arch, params, stats, head_dim=32, dtype="float32"):
    model = resnet.ResNet(arch, head_dim, dtype=dtype)
    model.load_state_dict(resnet_from_jax_params(params, stats, arch))
    return model


def assert_close(got, want):
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def running_stats(model) -> dict[str, np.ndarray]:
    return {k: v.numpy() for k, v in model.state_dict().items() if "running" in k}


def port_f64_forward(arch, params, stats, x, training, with_head):
    """The port's network in f64 on the same weights: (output, running stats)."""
    model = port_model(arch, params, stats).double().train(training)
    model.dtype = torch.float64
    with torch.no_grad():
        out = model(torch.from_numpy(x).double(), with_head=with_head).numpy()
    return out, {k: v.numpy() for k, v in model.state_dict().items() if "running" in k}


def plain_f64_forward(arch, params, stats, x, training, with_head):
    """The JAX package's ``apply`` evaluated in f64 on its own parameter
    tree, in plain ``torch.nn.functional``: (output, new running statistics
    as a JAX-layout tree)."""
    t = lambda a: torch.from_numpy(np.asarray(a, np.float64))

    def conv(h, w, stride=1):
        w = t(w).permute(3, 2, 0, 1)  # HWIO -> OIHW
        return F.conv2d(h, w, stride=stride, padding=w.shape[-1] // 2)

    def bn(h, p, s):
        if training:
            mean, var = h.mean((0, 2, 3)), h.var((0, 2, 3), unbiased=False)
            n = h.shape[0] * h.shape[2] * h.shape[3]
            new = {"mean": 0.9 * t(s["mean"]) + 0.1 * mean,
                   "var": 0.9 * t(s["var"]) + 0.1 * var * n / (n - 1)}
        else:
            mean, var, new = t(s["mean"]), t(s["var"]), s
        y = (h - mean[:, None, None]) / torch.sqrt(var[:, None, None] + 1e-5)
        return y * t(p["scale"])[:, None, None] + t(p["bias"])[:, None, None], new

    kind, _ = jax_resnet.BLOCKS[arch]
    convs, strides = (("conv1", "conv2"), (1, 0)) if kind == "basic" else (
        ("conv1", "conv2", "conv3"), (0, 1, 0))  # which conv takes the block's stride
    h = t(x).permute(0, 3, 1, 2)
    new_stats = {}
    h, new_stats["stem"] = bn(conv(h, params["stem"]["conv"], 2), params["stem"]["bn"],
                              stats["stem"])
    h = F.max_pool2d(F.relu(h), 3, 2, 1)
    for s in range(4):
        new_stats[f"stage{s}"] = []
        for b, (bp, bs) in enumerate(zip(params[f"stage{s}"], stats[f"stage{s}"])):
            stride = 2 if (s > 0 and b == 0) else 1
            y, nbs = h, {}
            for i, (c, strided) in enumerate(zip(convs, strides), start=1):
                y, nbs[f"bn{i}"] = bn(conv(y, bp[c], stride if strided else 1),
                                      bp[f"bn{i}"], bs[f"bn{i}"])
                if i < len(convs):
                    y = F.relu(y)
            identity = h
            if "down_conv" in bp:
                identity, nbs["down_bn"] = bn(conv(h, bp["down_conv"], stride),
                                              bp["down_bn"], bs["down_bn"])
            h = F.relu(y + identity)
            new_stats[f"stage{s}"].append(nbs)
    y = h.mean((2, 3))
    if with_head:
        hd = params["head"]
        y = F.relu(y @ t(hd["fc1"]["kernel"]) + t(hd["fc1"]["bias"]))
        y = y @ t(hd["fc2"]["kernel"]) + t(hd["fc2"]["bias"])
    return y.numpy(), new_stats


def stats_leaves(tree) -> list[np.ndarray]:
    return [np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v, np.float64)
            for v in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("with_head", [True, False], ids=["head", "features"])
def test_forward_matches_jax(arch, training, with_head):
    params, stats = jax_weights(arch)
    x = np.random.default_rng(1).normal(0, 1, (4, 48, 48, 3)).astype(np.float32)
    want, new_stats = jax_resnet.apply(params, stats, jnp.asarray(x), arch, training=training,
                                       with_head=with_head)
    want = np.asarray(want)
    model = port_model(arch, params, stats).train(training)
    with torch.no_grad():
        got = model(torch.from_numpy(x), with_head=with_head)
    width = 32 if with_head else resnet.feature_dim(arch)
    assert got.shape == (4, width) and got.dtype == torch.float32
    # the port's structure: its network in f64 meets the plain f64 evaluation
    exact, exact_tree = plain_f64_forward(arch, params, stats, x, training, with_head)
    port64, port64_stats = port_f64_forward(arch, params, stats, x, training, with_head)
    np.testing.assert_allclose(port64, exact, rtol=0, atol=1e-9 * np.abs(exact).max())
    exact_stats = running_stats(port_model(  # f32 copies under the port's names
        arch, params, jax.tree_util.tree_map(np.asarray, exact_tree)))
    for k, v in port64_stats.items():
        np.testing.assert_allclose(v, exact_stats[k], rtol=1e-6, atol=1e-9, err_msg=k)
    # the f32 limit: twice JAX's own distance from that f64 evaluation, itself
    # a rounding-size distance
    jax_err = np.abs(want - exact).max()
    assert jax_err <= 1e-3 * np.abs(exact).max(), jax_err
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=max(ATOL, 2 * jax_err))
    # train mode moves the running statistics as JAX's new_stats; eval keeps them
    ref = running_stats(port_model(arch, params, jax.tree_util.tree_map(np.asarray, new_stats)))
    jax_stats_err = max(np.abs(a - b).max() for a, b in
                        zip(stats_leaves(new_stats), stats_leaves(exact_tree)))
    assert jax_stats_err <= 1e-3, jax_stats_err
    atol = max(STATS_ATOL, 2 * jax_stats_err)
    for k, v in running_stats(model).items():
        np.testing.assert_allclose(v, ref[k], rtol=0, atol=atol, err_msg=k)
    if not training:
        assert all(np.array_equal(v, running_stats(port_model(arch, params, stats))[k])
                   for k, v in running_stats(model).items())
    if arch == "resnet18":  # well conditioned: the stated tolerances hold as they are
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
        for k, v in running_stats(model).items():
            np.testing.assert_allclose(v, ref[k], rtol=0, atol=STATS_ATOL, err_msg=k)


@pytest.mark.parametrize("arch", ["resnet18", "resnet34", "resnet50"])
def test_export_layout_is_jax_bit_for_bit(arch):
    params, stats = jax_weights(arch, head_dim=16)
    want = resnet_to_torch_state_dict(params, stats, arch)
    model = port_model(arch, params, stats, head_dim=16)
    got = resnet_to_torchvision_state_dict(model.state_dict())
    assert list(got) == list(want)  # torchvision's names in torchvision's order
    for k, v in want.items():
        assert got[k].dtype == torch.from_numpy(np.asarray(v)).dtype, k
        assert got[k].is_contiguous() and got[k].device.type == "cpu", k
        assert np.array_equal(got[k].numpy(), v), k
    # and back: the export layout loads into a fresh model unchanged
    fresh = resnet.ResNet(arch, 16, seed=3)
    fresh.load_state_dict(resnet_from_torchvision_state_dict(want))
    for k, v in fresh.state_dict().items():
        assert np.array_equal(v.numpy(), want[k]), k


def test_padding_is_symmetric_not_same():
    """A stride-2 7x7 convolution pads 3 on each side, as the JAX package's
    ``_conv`` (and torchvision); XLA's SAME would pad 2 before and 3 after
    on an even input."""
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 16, 16, 3)).astype(np.float32)
    w = rng.normal(0, 0.1, (7, 7, 3, 8)).astype(np.float32)
    conv = torch.nn.Conv2d(3, 8, 7, stride=2, padding=3, bias=False)
    conv.weight.data = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous()
    got = resnet.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), conv).permute(0, 2, 3, 1)
    want = np.asarray(jax_resnet._conv(jnp.asarray(x), jnp.asarray(w), stride=2))
    assert_close(got.detach().numpy(), want)
    same = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (2, 2), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")))
    assert same.shape == want.shape and np.abs(same - want).max() > 0.1


def test_max_pool_pads_with_minus_infinity():
    """The stem's pool is ``reduce_window`` with -inf padding 1: on an
    all-negative input a zero padding would show at the border."""
    x = -np.random.default_rng(3).uniform(1, 2, (2, 9, 9, 4)).astype(np.float32)
    want = np.asarray(jax.lax.reduce_window(
        jnp.asarray(x), -jnp.inf, jax.lax.max, (1, 3, 3, 1), (1, 2, 2, 1),
        [(0, 0), (1, 1), (1, 1), (0, 0)]))
    got = F.max_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want < 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_batch_norm_matches_jax(dtype, training):
    """f32 statistics over a bf16 input, the biased variance normalising,
    the unbiased one in the running variance (momentum 0.1, eps 1e-5), the
    output back in the input dtype; eval reads the running statistics."""
    rng = np.random.default_rng(4)
    x = rng.normal(0.5, 2.0, (3, 5, 6, 8)).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, 8).astype(np.float32),
         "bias": rng.normal(0, 0.3, 8).astype(np.float32)}
    s = {"mean": rng.normal(0, 0.2, 8).astype(np.float32),
         "var": rng.uniform(0.5, 1.5, 8).astype(np.float32)}
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want, new_s = jax_resnet._bn(jnp.asarray(x).astype(jdt), p, s, training)
    bn = torch.nn.BatchNorm2d(8, eps=1e-5, momentum=0.1).train(training)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(p["scale"]))
        bn.bias.copy_(torch.from_numpy(p["bias"]))
        bn.running_mean.copy_(torch.from_numpy(s["mean"]))
        bn.running_var.copy_(torch.from_numpy(s["var"]))
        xt = torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2)
        got = bn(xt).permute(0, 2, 3, 1)
    assert got.dtype == dtype
    want = np.asarray(want.astype(jnp.float32))
    if dtype == torch.float32:
        assert_close(got.numpy(), want)
    else:  # the same f32 values rounded to bf16, or one bf16 step apart
        assert np.abs(got.float().numpy() - want).max() <= 2 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(new_s["mean"]),
                               rtol=0, atol=STATS_ATOL)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(new_s["var"]),
                               rtol=0, atol=STATS_ATOL)


def _grouped_forward(dtype: str):
    """JAX's ``apply(..., bn_groups=2)`` in train mode and the port's ResNet
    with ``bn_groups = 2`` on the same weights and input: (got, want,
    the port's model, the running statistics JAX moved to)."""
    params, stats = jax_weights("resnet18")
    x = np.random.default_rng(2).normal(0, 1, (4, 48, 48, 3)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want, new_stats = jax_resnet.apply(params, stats, jnp.asarray(x), "resnet18", training=True,
                                       dtype=jdt, bn_groups=2)
    model = port_model("resnet18", params, stats, dtype=dtype)
    model.bn_groups = 2
    with torch.no_grad():
        got = model.train()(torch.from_numpy(x)).float().numpy()
    ref = running_stats(port_model("resnet18", params,
                                   jax.tree_util.tree_map(np.asarray, new_stats)))
    return got, np.asarray(want.astype(jnp.float32)), model, ref, (params, stats, x)


def test_bn_groups_need_several_gpus():
    """``bn_groups`` once raised in the port (name kept).  Now G = 2 takes
    train mode's batch statistics over each half of the batch and moves the
    running ones by the first half's, as JAX's ``apply(..., bn_groups=2)``
    (the reference's per-rank DDP BatchNorm in one process): the f32 output
    within the forward test's limits, the running statistics also within
    rtol 1e-5 (chunks of 8 values at 48 px in ``layer4``, summed in another
    order); a G that does not divide the batch, G < 1 and an unknown
    architecture raise."""
    got, want, model, ref, (params, stats, x) = _grouped_forward("float32")
    assert_close(got, want)
    for k, v in running_stats(model).items():
        np.testing.assert_allclose(v, ref[k], rtol=1e-5, atol=STATS_ATOL, err_msg=k)
    # one group is not two: the statistics differ from the whole batch's
    whole = port_model("resnet18", params, stats)
    with torch.no_grad():
        assert not np.allclose(whole.train()(torch.from_numpy(x)).numpy(), got, atol=1e-3)
    model.bn_groups = 3
    with pytest.raises(ValueError, match="does not divide"):
        model(torch.from_numpy(x))
    with pytest.raises(ValueError, match="bn_groups"):
        resnet.ResNet("resnet18", bn_groups=0)
    with pytest.raises(ValueError, match="resnet101"):
        resnet.ResNet("resnet101")


def test_bn_groups_in_bf16():
    """The same in bf16: cosine 0.999 per row, running statistics 1e-2."""
    got, want, model, ref, _ = _grouped_forward("bfloat16")
    cos = (got * want).sum(1) / np.linalg.norm(got, axis=1) / np.linalg.norm(want, axis=1)
    assert cos.min() >= 0.999, cos
    for k, v in running_stats(model).items():
        np.testing.assert_allclose(v, ref[k], rtol=0, atol=1e-2, err_msg=k)


def test_convolutions_run_channels_last():
    """NHWC input: the model permutes the view only, so every convolution
    sees (and gives) channels_last memory, and its weights are stored so."""
    model = resnet.ResNet("resnet18", 16)
    seen = []
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.register_forward_hook(lambda mod, inp, out: seen.append(
                inp[0].is_contiguous(memory_format=torch.channels_last)))
    with torch.no_grad():
        model(torch.zeros(2, 32, 32, 3))
    assert len(seen) == 20 and all(seen)
    assert model.conv1.weight.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_bf16_forward_close_to_jax(arch):
    """bf16 compute from f32 weights on both sides (convolutions in bf16,
    BatchNorm in f32, the head's bias rounded at another place): cosine >=
    0.999 per row, eval mode, with the head."""
    params, stats = jax_weights(arch)
    x = np.random.default_rng(5).normal(0, 1, (4, 32, 32, 3)).astype(np.float32)
    want, _ = jax_resnet.apply(params, stats, jnp.asarray(x), arch, training=False,
                               dtype=jnp.bfloat16)
    model = port_model(arch, params, stats, dtype="bfloat16").eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    a, b = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
    assert cos.min() >= 0.999, cos


def test_init_follows_jax_distributions():
    """Kaiming-normal fan-out convolutions, torch-default uniform linears,
    BatchNorm scale 1, bias 0, running mean 0 and variance 1; seeded."""
    model = resnet.ResNet("resnet50", 64, seed=7)
    w = model.layer3[0].conv2.weight  # 3x3, 256 out: std sqrt(2 / 2304)
    assert abs(w.std().item() / np.sqrt(2 / (9 * 256)) - 1) < 0.02
    b = 1 / np.sqrt(2048)
    assert model.fc[0].weight.abs().max() <= b and model.fc[0].weight.abs().max() > 0.99 * b
    assert model.fc[0].bias.abs().max() <= b
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            assert (m.weight == 1).all() and (m.bias == 0).all()
            assert (m.running_mean == 0).all() and (m.running_var == 1).all()
    again = resnet.ResNet("resnet50", 64, seed=7)
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 again.state_dict().values()))
