"""Weights carried into the port's VideoMAE and JEPA modules (f32 state
dicts).

- :func:`videomae_from_jax_params`: the JAX package's parameter tree as
  numpy arrays (block leaves stacked ``[depth, ...]``, kernels ``[in, out]``)
  -> the state dict of :class:`VideoMAEEncoder` (``patch_embed.*``,
  ``blocks.layers.{i}.*``).  A block tree quantized by JAX's
  ``quantize_encoder_tree`` (linears with ``kernel_q [L, in, out]`` int8
  and ``scale [L, out]``) gives ``weight_q``/``scale`` entries, which load
  into an encoder quantized by :func:`bvc_tpu_torch.ops.quant.quantize_encoder`;
  the same holds for :func:`jepa_encoder_from_jax_params`.
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
- :func:`jepa_from_jax_params`: the JAX package's JEPA tree
  ``{"encoder", "predictor"}`` as numpy arrays -> the state dict of
  :class:`~bvc_tpu_torch.models.jepa.JEPA`;
  :func:`jepa_encoder_from_jax_params`: its ``encoder`` subtree (or an EMA
  target) -> the state dict of :class:`JEPAEncoder`.
- :func:`jepa_encoder_from_reference_state_dict`: the reference
  ``VisionTransformer`` names, as ``bvc_tpu/cli/export_torch.py`` writes a
  JEPA checkpoint's ``encoder`` into ``model_{run_id}.pth.tar`` -> the state
  dict of :class:`JEPAEncoder` (``pos_embed`` is recomputed, not read).
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
    """A JAX ``{kernel [in, out], bias?}`` leaf -> ``nn.Linear`` entries; a
    quantized ``{kernel_q [in, out] int8, scale [out], bias?}`` leaf ->
    :class:`~bvc_tpu_torch.ops.quant.QuantLinear` entries (``weight_q``
    ``[out, in]`` int8, ``scale``)."""
    if "kernel_q" in p:
        kq = np.ascontiguousarray(np.asarray(p["kernel_q"], dtype=np.int8).T)
        sd = {prefix + "weight_q": torch.from_numpy(kq), prefix + "scale": _f32(p["scale"])}
    else:
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


def jepa_encoder_from_jax_params(tree: dict, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """JAX ``jepa.init_encoder_params``-shaped tree -> encoder state dict."""
    return {**_linear(tree["patch_embed"], "patch_embed."),
            **_blocks(tree["blocks"], cfg.depth, "blocks."),
            "norm.weight": _f32(tree["norm"]["scale"]),
            "norm.bias": _f32(tree["norm"]["bias"])}


def jepa_from_jax_params(tree: dict, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """JAX ``jepa.init_params``-shaped tree -> :class:`JEPA` state dict
    (encoder and predictor)."""
    pred = tree["predictor"]
    sd = {"encoder." + k: x for k, x in jepa_encoder_from_jax_params(tree["encoder"], cfg).items()}
    sd.update({"predictor." + k: x for k, x in {
        **_linear(pred["embed"], "embed."),
        "mask_token": _f32(pred["mask_token"]),
        **_blocks(pred["blocks"], cfg.pred_depth, "blocks."),
        "norm.weight": _f32(pred["norm"]["scale"]),
        "norm.bias": _f32(pred["norm"]["bias"]),
        **_linear(pred["proj"], "proj."),
    }.items()})
    return sd


def jepa_encoder_from_reference_state_dict(sd: dict, cfg: ModelConfig
                                           ) -> dict[str, torch.Tensor]:
    """Reference ``VisionTransformer.state_dict()`` (``patch_embed.proj``
    as a Conv3d ``[D, C, ts, p, p]``, ``blocks.{i}.{norm1,attn.qkv,
    attn.proj,norm2,mlp.fc1,mlp.fc2}``, ``norm``) -> encoder state dict."""
    proj = _f32(sd["patch_embed.proj.weight"])
    out = {"patch_embed.weight": proj.reshape(proj.shape[0], -1),
           "patch_embed.bias": _f32(sd["patch_embed.proj.bias"]),
           "norm.weight": _f32(sd["norm.weight"]), "norm.bias": _f32(sd["norm.bias"])}
    for i in range(cfg.depth):
        src, dst = f"blocks.{i}.", f"blocks.layers.{i}."
        for ours, theirs in (("ln1", "norm1"), ("qkv", "attn.qkv"), ("proj", "attn.proj"),
                             ("ln2", "norm2"), ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            for leaf in ("weight", "bias"):
                out[f"{dst}{ours}.{leaf}"] = _f32(sd[f"{src}{theirs}.{leaf}"])
    return out
