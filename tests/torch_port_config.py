"""The port's configuration fields that the JAX package's dataclasses lack,
and the defaults at which the port behaves as the JAX package does: V-JEPA
2's options (rotary positions, the predictor's own heads and MLP ratio, the
3-D collator's block count) and Hiera's stage layout.  The parity tests take them out, each checked
at its default, before they compare a port configuration with JAX's."""

from __future__ import annotations

import copy

PORT_ONLY = {"model": {"pred_num_heads": 0, "pred_mlp_ratio": 0.0, "pos_embed": "sincos3d",
                       "stage_depths": (), "stage_heads": (), "dim_mul": 2.0, "q_pool": 2,
                       "q_stride": (1, 2, 2), "mask_unit_size": (1, 8, 8),
                       "mask_unit_attn": (True, True, False, False),
                       "patch_kernel": (3, 7, 7), "patch_padding": (1, 3, 3)},
             "mask": {"pred_num_blocks": 8}}


def without_port_only(fields: dict, group: str) -> dict:
    """``fields`` (one config group's ``{name: value}``) without the
    port-only fields of ``group``; raises unless each is at its default."""
    out = dict(fields)
    for name, default in PORT_ONLY.get(group, {}).items():
        value = out.pop(name)
        value = tuple(value) if isinstance(value, list) else value  # a yaml dump's tuple
        assert value == default, f"{group}.{name} = {value!r}, not the default {default!r}"
    return out


def jax_comparable(train_cfg: dict) -> dict:
    """``dataclasses.asdict`` (or the yaml dump) of a port ``TrainConfig``
    with the port-only fields taken out, in order, each checked at its
    default."""
    out = copy.deepcopy(train_cfg)
    for group in PORT_ONLY:
        out[group] = without_port_only(out[group], group)
    return out
