"""The port's optimizers against the JAX package's optax chains: five
updates of a small parameter tree from the same gradients (numpy, from a
seed), and the two schedules value by value.

Tolerance: 1e-6 absolute and relative (f32 updates; the two sides round
the same operations in another order).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bvc_tpu.training.optim import apply_gradients
from bvc_tpu.training.optim import cosine_wd as jax_cosine_wd
from bvc_tpu.training.optim import make_optimizer as jax_make_optimizer
from bvc_tpu.training.optim import warmup_cosine_lr as jax_warmup_cosine_lr
from bvc_tpu.utils.config import OptimConfig as JaxOptimConfig
from bvc_tpu_torch.training.optim import (apply_schedules, cosine_wd, make_optimizer,
                                          warmup_cosine_lr, wd_mask)
from bvc_tpu_torch.utils.config import OptimConfig

TOL = 1e-6
SHAPES = {"kernel": (6, 5), "bias": (5,), "token": (1, 1, 4)}
STEPS = (2, 8)  # (warmup, total) of the scheduled cases

CASES = {
    "sgd_nesterov": dict(name="sgd"),
    "sgd_nesterov_wd": dict(name="sgd", weight_decay=1e-2),
    "sgd_wd_ndim_mask": dict(name="sgd", weight_decay=1e-2,
                             exclude_bias_and_norm_from_wd=True),
    "sgd_scheduled": dict(name="sgd", weight_decay=1e-2, schedule="warmup_cosine",
                          start_lr=0.01, final_lr=0.001, final_wd=0.05,
                          exclude_bias_and_norm_from_wd=True),
    "adam_wd": dict(name="adam", lr=1e-2, weight_decay=1e-2),
    "adam_scheduled": dict(name="adam", lr=1e-2, weight_decay=1e-2,
                           schedule="warmup_cosine", final_wd=0.0),
    "adamw_wd_ndim_mask": dict(name="adamw", lr=1e-2, weight_decay=5e-2,
                               exclude_bias_and_norm_from_wd=True),
    "adamw_scheduled": dict(name="adamw", lr=1e-2, weight_decay=5e-2,
                            schedule="warmup_cosine", start_lr=1e-3),
}


@pytest.mark.parametrize("case", CASES)
def test_five_updates_match_optax(case):
    kw = CASES[case]
    rng = np.random.default_rng(0)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(5)]
    scheduled = kw.get("schedule") == "warmup_cosine" or "final_wd" in kw

    tx = jax_make_optimizer(JaxOptimConfig(**kw), params, STEPS if scheduled else None)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    for g in grads:
        jp, state = apply_gradients(tx, {k: jnp.asarray(v) for k, v in g.items()}, state, jp)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = make_optimizer(OptimConfig(**kw), tp.items(), STEPS if scheduled else None)
    for count, g in enumerate(grads):
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        apply_schedules(opt, count)
        opt.step()
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)


def test_schedules_match_jax():
    lr, ref_lr = warmup_cosine_lr(0.01, 0.1, 0.001, 3, 10), jax_warmup_cosine_lr(
        0.01, 0.1, 0.001, 3, 10)
    for up, down in ((0.1, 0.01), (0.01, 0.1)):  # final below and above ref
        wd, ref_wd = cosine_wd(up, down, 10), jax_cosine_wd(up, down, 10)
        for count in range(14):
            np.testing.assert_allclose(wd(count), float(ref_wd(count)), rtol=TOL)
    for count in range(14):
        np.testing.assert_allclose(lr(count), float(ref_lr(count)), rtol=TOL)


def test_wd_mask_is_ndim_at_least_two():
    named = [(k, torch.zeros(s)) for k, s in SHAPES.items()]
    assert wd_mask(named) == {"kernel": True, "bias": False, "token": True}


def test_invalid_configs_raise():
    named = [("w", torch.nn.Parameter(torch.zeros(2, 2)))]
    with pytest.raises(ValueError, match="invalid optimizer"):
        make_optimizer(OptimConfig(name="lamb"), named)
    with pytest.raises(ValueError, match="no \\(warmup, total\\) steps"):
        make_optimizer(OptimConfig(schedule="warmup_cosine"), named)
    with pytest.raises(ValueError, match="invalid schedule"):
        make_optimizer(OptimConfig(schedule="step"), named)
    with pytest.raises(ValueError, match="weight_decay is 0"):
        make_optimizer(OptimConfig(final_wd=0.1), named, STEPS)
