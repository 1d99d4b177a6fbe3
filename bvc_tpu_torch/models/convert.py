"""Weights carried into the port's VideoMAE modules (f32 state dicts).

- :func:`videomae_from_jax_params`: the JAX package's parameter tree as
  numpy arrays (block leaves stacked ``[depth, ...]``, kernels ``[in, out]``)
  -> the state dict of :class:`VideoMAEEncoder` (``patch_embed.*``,
  ``blocks.layers.{i}.*``).
- :func:`videomae_pretrain_from_jax_params`: the same tree -> the state
  dict of :class:`VideoMAEPretrain`: the encoder's entries under
  ``encoder.``, and from the tree's decoder side ``enc_to_dec.weight``,
  ``mask_token``, ``decoder.layers.{i}.{ln1,qkv,proj,ln2,fc1,fc2}.*``,
  ``decoder_norm.{weight,bias}`` and ``decoder_head.{weight,bias}``.
- :func:`videomae_from_hf_state_dict`: HF ``VideoMAEForPreTraining`` names,
  as ``bvc_tpu/cli/export_torch.py`` writes them into
  ``model_{run_id}.pth.tar`` -> the encoder's state dict.  HF has no k bias,
  so the fused qkv bias gets zeros in its k third.  The HF decoder entries
  are not read yet (ROADMAP).
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


def _linear(p: dict, prefix: str) -> dict[str, torch.Tensor]:
    """A JAX ``{kernel [in, out], bias?}`` leaf -> ``nn.Linear`` entries."""
    sd = {prefix + "weight": _f32(p["kernel"]).T.contiguous()}
    if "bias" in p:
        sd[prefix + "bias"] = _f32(p["bias"])
    return sd


def _blocks(stacked: dict, depth: int, prefix: str) -> dict[str, torch.Tensor]:
    """Stacked JAX block leaves ``[depth, ...]`` -> ``Blocks`` entries."""
    linears = (("qkv", stacked["attn"]["qkv"]), ("proj", stacked["attn"]["proj"]),
               ("fc1", stacked["mlp"]["fc1"]), ("fc2", stacked["mlp"]["fc2"]))
    sd = {}
    for i in range(depth):
        pre = f"{prefix}layers.{i}."
        for name in ("ln1", "ln2"):
            sd[pre + name + ".weight"] = _f32(stacked[name]["scale"][i])
            sd[pre + name + ".bias"] = _f32(stacked[name]["bias"][i])
        for name, p in linears:
            sd.update(_linear({k: x[i] for k, x in p.items()}, pre + name + "."))
    return sd


def videomae_from_jax_params(tree: dict, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """JAX ``videomae.init_params``-shaped tree -> encoder state dict."""
    return {**_linear(tree["patch_embed"], "patch_embed."),
            **_blocks(tree["encoder"], cfg.depth, "blocks.")}


def videomae_pretrain_from_jax_params(tree: dict, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """JAX ``videomae.init_params``-shaped tree -> pretraining-model state
    dict (encoder and decoder)."""
    sd = {"encoder." + k: x for k, x in videomae_from_jax_params(tree, cfg).items()}
    sd.update(_linear(tree["enc_to_dec"], "enc_to_dec."))
    sd["mask_token"] = _f32(tree["mask_token"])
    sd.update(_blocks(tree["decoder"], cfg.decoder_depth, "decoder."))
    sd["decoder_norm.weight"] = _f32(tree["decoder_norm"]["scale"])
    sd["decoder_norm.bias"] = _f32(tree["decoder_norm"]["bias"])
    sd.update(_linear(tree["decoder_head"], "decoder_head."))
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
