"""Weights carried into the port's :class:`VideoMAEEncoder`.

Two sources, both returning the encoder's state dict (f32 tensors):

- :func:`videomae_from_jax_params`: the JAX package's parameter tree as
  numpy arrays (block leaves stacked ``[depth, ...]``, kernels ``[in, out]``);
- :func:`videomae_from_hf_state_dict`: HF ``VideoMAEForPreTraining`` names,
  as ``bvc_tpu/cli/export_torch.py`` writes them into
  ``model_{run_id}.pth.tar``.  HF has no k bias, so the fused qkv bias gets
  zeros in its k third.

Decoder entries in either source are ignored: the port embeds with the
encoder only.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from bvc_tpu_torch.utils.config import ModelConfig


def _f32(x: Any) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, dtype=np.float32)))


def videomae_from_jax_params(tree: dict, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """JAX ``videomae.init_params``-shaped tree -> encoder state dict."""
    pe = tree["patch_embed"]
    sd = {"patch_embed.weight": _f32(pe["kernel"]).T.contiguous(),
          "patch_embed.bias": _f32(pe["bias"])}
    enc = tree["encoder"]
    linears = (("qkv", enc["attn"]["qkv"]), ("proj", enc["attn"]["proj"]),
               ("fc1", enc["mlp"]["fc1"]), ("fc2", enc["mlp"]["fc2"]))
    for i in range(cfg.depth):
        pre = f"blocks.layers.{i}."
        for name in ("ln1", "ln2"):
            sd[pre + name + ".weight"] = _f32(enc[name]["scale"][i])
            sd[pre + name + ".bias"] = _f32(enc[name]["bias"][i])
        for name, p in linears:
            sd[pre + name + ".weight"] = _f32(p["kernel"][i]).T.contiguous()
            if "bias" in p:
                sd[pre + name + ".bias"] = _f32(p["bias"][i])
    return sd


def videomae_from_hf_state_dict(sd: dict, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """HF ``VideoMAEForPreTraining``/``VideoMAEForVideoClassification``
    state dict -> encoder state dict."""
    proj = _f32(sd["videomae.embeddings.patch_embeddings.projection.weight"])
    out = {"patch_embed.weight": proj.reshape(proj.shape[0], -1),
           "patch_embed.bias": _f32(sd["videomae.embeddings.patch_embeddings.projection.bias"])}
    for i in range(cfg.depth):
        src, dst = f"videomae.encoder.layer.{i}.", f"blocks.layers.{i}."
        g = lambda name: _f32(sd[src + name])  # noqa: E731
        att = "attention.attention."
        out[dst + "qkv.weight"] = torch.cat(
            [g(att + "query.weight"), g(att + "key.weight"), g(att + "value.weight")])
        if src + att + "q_bias" in sd:
            q_bias = g(att + "q_bias")
            out[dst + "qkv.bias"] = torch.cat(
                [q_bias, torch.zeros_like(q_bias), g(att + "v_bias")])
        for ours, theirs in (("ln1", "layernorm_before"), ("ln2", "layernorm_after"),
                             ("proj", "attention.output.dense"),
                             ("fc1", "intermediate.dense"), ("fc2", "output.dense")):
            out[dst + ours + ".weight"] = g(theirs + ".weight")
            out[dst + ours + ".bias"] = g(theirs + ".bias")
    return out
