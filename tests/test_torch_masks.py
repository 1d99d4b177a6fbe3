"""The port's tube and random masks: structure and counts (the draws of a
``torch.Generator`` differ from ``jax.random``'s), and ``mask_partition``
against the JAX one on the same numpy mask, index for index."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvc_tpu.masks.tube import mask_partition as jax_mask_partition
from bvc_tpu_torch.masks.tube import mask_partition, random_mask, tube_mask

GRID = (8, 14, 14)  # VideoMAE-B: 8 sheets of 14 x 14 patches


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_tube_mask_structure():
    mask = tube_mask(_gen(0), 6, GRID, 0.9)
    assert mask.shape == (6, 8 * 196) and mask.dtype == torch.bool
    assert (mask.sum(1) == 8 * int(0.9 * 196)).all()  # 176 of 196 per sheet
    sheets = mask.view(6, 8, 196)
    assert (sheets == sheets[:, :1]).all()  # one spatial pattern across sheets
    assert len({tuple(row.tolist()) for row in sheets[:, 0]}) == 6  # samples differ


def test_random_mask_structure():
    mask = random_mask(_gen(1), 6, GRID, 0.9)
    assert mask.shape == (6, 8 * 196)
    assert (mask.sum(1) == int(0.9 * 8 * 196)).all()
    sheets = mask.view(6, 8, 196)
    assert not (sheets == sheets[:, :1]).all()  # no tubes
    assert len({tuple(row.tolist()) for row in mask}) == 6


def test_masks_follow_the_generator():
    a, b = tube_mask(_gen(3), 2, GRID, 0.9), tube_mask(_gen(3), 2, GRID, 0.9)
    assert torch.equal(a, b)
    gen = _gen(3)
    first, second = tube_mask(gen, 2, GRID, 0.9), tube_mask(gen, 2, GRID, 0.9)
    assert torch.equal(first, a) and not torch.equal(first, second)


@pytest.mark.parametrize("sampler", ["tube", "random"])
def test_mask_partition_matches_jax(sampler):
    fn = tube_mask if sampler == "tube" else random_mask
    mask = fn(_gen(4), 3, GRID, 0.9).numpy()
    num_visible = int((~mask[0]).sum())
    ref_vis, ref_msk = jax_mask_partition(jnp.asarray(mask), num_visible)
    vis, msk = mask_partition(torch.from_numpy(mask), num_visible)
    np.testing.assert_array_equal(vis.numpy(), np.asarray(ref_vis))
    np.testing.assert_array_equal(msk.numpy(), np.asarray(ref_msk))
    # visible first, each part in ascending position order
    assert not mask[np.arange(3)[:, None], vis.numpy()].any()
    assert mask[np.arange(3)[:, None], msk.numpy()].all()
    assert (np.diff(vis.numpy(), axis=1) > 0).all() and (np.diff(msk.numpy(), axis=1) > 0).all()
