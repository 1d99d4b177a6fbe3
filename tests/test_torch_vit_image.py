"""The port's image ViT (``bvc_tpu_torch.models.vit_image``) against the JAX
package's (``bvc_tpu.models.vit_image``) in f32 from the same weights
(``vit_image_from_jax_params``): ``forward`` without and with ``keep_idx``
(rows padded with -1), ``embed``, and an input at another resolution, which
reads the position table resized bicubically; ``patchify_image``'s order
(``tests/test_misc.py``); and the 2-D tables, ``sincos_2d`` and
``interpolate_pos_table``, equal to JAX's to the bit (both are numpy).

The model is 128 wide with 2 heads (head width 64, the width of the
attention kernels).  Tolerance 1e-5 absolute and relative, as
``tests/test_torch_jepa.py``: the two sides differ in summation order and
in where the patch embedding adds its bias.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvc_tpu.models import posenc as jax_posenc
from bvc_tpu.models import vit_image as jax_vit_image
from bvc_tpu.utils.config import ModelConfig as JaxModelConfig
from bvc_tpu_torch.models import posenc
from bvc_tpu_torch.models.convert import vit_image_from_jax_params
from bvc_tpu_torch.models.vit_image import ImageViT, patchify_image
from bvc_tpu_torch.ops import attention
from bvc_tpu_torch.utils.config import ModelConfig

TINY = dict(image_size=32, patch_size=8, hidden_size=128, depth=2, num_heads=2, mlp_ratio=2.0,
            dtype="float32")
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(size: int = 32, b: int = 3):
    """JAX params (perturbed off their init so no tensor is zero), the
    port's model on the same weights, and ``[b, size, size, 3]`` images."""
    jcfg = JaxModelConfig(**TINY)
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(0, 0.02, x.shape).astype(np.float32),
        jax_vit_image.init_params(jax.random.PRNGKey(0), jcfg))
    model = ImageViT(ModelConfig(**TINY))
    model.load_state_dict(vit_image_from_jax_params(tree, model.cfg))
    images = rng.standard_normal((b, size, size, 3)).astype(np.float32)
    return jcfg, tree, model, images


def _close(ours: torch.Tensor, ref):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("size", [32, 48])
def test_forward_and_embed_match_jax(size):
    """Full forward and embed; at 48 px the 6 x 6 grid reads the 4 x 4
    table resized."""
    jcfg, tree, model, images = _setup(size)
    with torch.no_grad():
        out = model(torch.from_numpy(images))
        emb = model.embed(torch.from_numpy(images))
    assert out.shape == (3, (size // 8) ** 2, 128) and emb.dtype == torch.float32
    _close(out, jax_vit_image.forward(tree, jnp.asarray(images), jcfg))
    _close(emb, jax_vit_image.embed(tree, jnp.asarray(images), jcfg))


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_keep_idx_matches_jax(impl):
    """A subset of the tokens, rows of 12, 10 and 9 kept padded to 12 with
    -1: the key mask of every block, through the plain masked attention or
    the key-bias kernels' plain version (``attn_impl='flash'``)."""
    jcfg, tree, model, images = _setup()
    rng = np.random.default_rng(1)
    keep = np.full((3, 12), -1, np.int32)
    for i, k in enumerate((12, 10, 9)):
        keep[i, :k] = np.sort(rng.permutation(16)[:k])
    with torch.no_grad():
        out = model(torch.from_numpy(images), torch.from_numpy(keep).long(), attn_impl=impl)
    want = np.asarray(jax_vit_image.forward(tree, jnp.asarray(images), jcfg,
                                            jnp.asarray(keep)))
    assert out.shape == (3, 12, 128)
    _close(out, want)


def test_auto_route_takes_the_kernels(monkeypatch):
    """With the route forced to the kernels, the masked and the unmasked
    forward call the flash operators, whose plain versions agree with the
    plain path."""
    _, _, model, images = _setup()
    keep = torch.from_numpy(np.array([[0, 2, 5, 7, -1], [1, 3, 4, 9, 11]]))
    x = torch.from_numpy(images[:2])
    with torch.no_grad():
        plain = [model(x, attn_impl="xla"), model(x, keep, attn_impl="xla")]
        monkeypatch.setattr(attention, "attention_route", lambda *a: "flash")
        calls = []
        real = attention.flash_attention
        monkeypatch.setattr(attention, "flash_attention",
                            lambda *a, **kw: calls.append(kw["bias"] is not None) or real(*a, **kw))
        routed = [model(x), model(x, keep)]
    assert calls == [False, False, True, True]  # two blocks each
    for got, want in zip(routed, plain):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL)


def test_patchify_image_order():
    imgs = torch.arange(16, dtype=torch.float32).reshape(1, 4, 4, 1)
    blocks = patchify_image(imgs, 2).numpy()
    np.testing.assert_allclose(blocks[0, 0], [0, 1, 4, 5])
    np.testing.assert_allclose(blocks[0, 1], [2, 3, 6, 7])
    rgb = np.random.default_rng(2).standard_normal((2, 8, 12, 3)).astype(np.float32)
    np.testing.assert_array_equal(patchify_image(torch.from_numpy(rgb), 4).numpy(),
                                  np.asarray(jax_vit_image.patchify_image(jnp.asarray(rgb), 4)))


@pytest.mark.parametrize("dim,grid,cls", [(128, 4, False), (768, 14, False), (64, 7, True)])
def test_sincos_2d_equals_jax(dim, grid, cls):
    np.testing.assert_array_equal(posenc.sincos_2d(dim, grid, cls),
                                  jax_posenc.sincos_2d(dim, grid, cls))


@pytest.mark.parametrize("grid,npatch,cls", [(4, 36, False), (14, 256, False), (14, 196, True),
                                             (16, 144, True)])
def test_interpolate_pos_table_equals_jax(grid, npatch, cls):
    table = jax_posenc.sincos_2d(64, grid, cls)
    np.testing.assert_array_equal(posenc.interpolate_pos_table(table, npatch, cls),
                                  jax_posenc.interpolate_pos_table(table, npatch, cls))


def test_interpolate_pos_table_refuses_non_squares():
    with pytest.raises(ValueError, match="square"):
        posenc.interpolate_pos_table(posenc.sincos_2d(16, 4), 20)
