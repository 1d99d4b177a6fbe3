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
  so the fused qkv bias gets zeros in its k third.
  :func:`videomae_pretrain_from_hf_state_dict` fills the pretraining model,
  encoder and decoder, and :func:`videomae_pretrain_to_hf_state_dict` is
  its inverse, key for key what ``bvc_tpu.models.torch_interop``'s
  ``videomae_to_hf_state_dict`` writes (the k thirds of the qkv biases
  dropped; a trainer's checkpoint keeps them beside, see
  :func:`qkv_key_biases`).
- :func:`jepa_from_jax_params`: the JAX package's JEPA tree
  ``{"encoder", "predictor"}`` as numpy arrays -> the state dict of
  :class:`~bvc_tpu_torch.models.jepa.JEPA`;
  :func:`jepa_encoder_from_jax_params`: its ``encoder`` subtree (or an EMA
  target) -> the state dict of :class:`JEPAEncoder`.
- :func:`vit_image_from_jax_params`: the JAX package's image-ViT tree
  (``patch_embed``, ``blocks``, ``norm``, the JEPA encoder's layout) -> the
  state dict of :class:`~bvc_tpu_torch.models.vit_image.ImageViT`.
- :func:`jepa_encoder_from_reference_state_dict`: the reference
  ``VisionTransformer`` names, as ``bvc_tpu/cli/export_torch.py`` writes a
  JEPA checkpoint's ``encoder`` into ``model_{run_id}.pth.tar`` -> the state
  dict of :class:`JEPAEncoder` (``pos_embed`` is recomputed, not read);
  :func:`jepa_predictor_from_reference_state_dict` the same for the
  predictor's ``VisionTransformerPredictor`` names.  Their inverses,
  :func:`jepa_encoder_to_reference` and :func:`jepa_predictor_to_reference`,
  write those layouts with the fixed position tables, as
  ``bvc_tpu.models.torch_interop`` does.
- :func:`resnet_from_jax_params`: the JAX package's ResNet ``(params,
  batch_stats)`` as numpy arrays (convolutions HWIO, kernels ``[in,
  out]``) -> the state dict of :class:`~bvc_tpu_torch.models.resnet.ResNet`
  (OIHW, ``[out, in]``, torchvision names, ``num_batches_tracked`` 0).
  The model keeps torchvision's names, so the export layout,
  ``bvc_tpu.models.torch_interop``'s ``resnet_to_torch_state_dict``, is its
  state dict on the CPU in f32: :func:`resnet_to_torchvision_state_dict`
  writes it (the SimCLR checkpoint's ``model_state_dict``) and
  :func:`resnet_from_torchvision_state_dict` reads it back.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from bvc_tpu_torch.models.posenc import positional_encoding_3d
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


_HF_BLOCK = (("proj", "attention.output.dense"), ("ln1", "layernorm_before"),
             ("ln2", "layernorm_after"), ("fc1", "intermediate.dense"),
             ("fc2", "output.dense"))
_HF_ATT = "attention.attention."


def _blocks_from_hf(sd: dict, src_prefix: str, dst_prefix: str, depth: int
                    ) -> dict[str, torch.Tensor]:
    """HF ``VideoMAELayer`` entries ``{src_prefix}{i}.*`` -> ``Blocks``
    entries ``{dst_prefix}{i}.*``."""
    out = {}
    for i in range(depth):
        src, dst = f"{src_prefix}{i}.", f"{dst_prefix}{i}."
        g = lambda name: _f32(sd[src + name])  # noqa: E731
        out[dst + "qkv.weight"] = torch.cat(
            [g(_HF_ATT + "query.weight"), g(_HF_ATT + "key.weight"),
             g(_HF_ATT + "value.weight")])
        if src + _HF_ATT + "q_bias" in sd:
            q_bias = g(_HF_ATT + "q_bias")
            out[dst + "qkv.bias"] = torch.cat(
                [q_bias, torch.zeros_like(q_bias), g(_HF_ATT + "v_bias")])
        for ours, theirs in _HF_BLOCK:
            out[dst + ours + ".weight"] = g(theirs + ".weight")
            out[dst + ours + ".bias"] = g(theirs + ".bias")
    return out


def _blocks_to_hf(sd: dict, src_prefix: str, dst_prefix: str, depth: int
                  ) -> dict[str, torch.Tensor]:
    """Inverse of :func:`_blocks_from_hf`: the k third of a qkv bias is
    dropped (HF has no k bias)."""
    out = {}
    for i in range(depth):
        src, dst = f"{src_prefix}{i}.", f"{dst_prefix}{i}."
        qkv = _f32(sd[src + "qkv.weight"])
        d = qkv.shape[1]
        for j, name in enumerate(("query", "key", "value")):
            out[f"{dst}{_HF_ATT}{name}.weight"] = qkv[j * d:(j + 1) * d].clone()
        if src + "qkv.bias" in sd:
            b = _f32(sd[src + "qkv.bias"])
            out[dst + _HF_ATT + "q_bias"] = b[:d].clone()
            out[dst + _HF_ATT + "v_bias"] = b[2 * d:].clone()
        for ours, theirs in _HF_BLOCK:
            out[dst + theirs + ".weight"] = _f32(sd[src + ours + ".weight"])
            out[dst + theirs + ".bias"] = _f32(sd[src + ours + ".bias"])
    return out


def videomae_from_hf_state_dict(sd: dict, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """HF ``VideoMAEForPreTraining``/``VideoMAEForVideoClassification``
    state dict -> encoder state dict."""
    proj = _f32(sd["videomae.embeddings.patch_embeddings.projection.weight"])
    return {"patch_embed.weight": proj.reshape(proj.shape[0], -1),
            "patch_embed.bias": _f32(sd["videomae.embeddings.patch_embeddings.projection.bias"]),
            **_blocks_from_hf(sd, "videomae.encoder.layer.", "blocks.layers.", cfg.depth)}


def videomae_pretrain_from_hf_state_dict(sd: dict, cfg: ModelConfig
                                         ) -> dict[str, torch.Tensor]:
    """HF ``VideoMAEForPreTraining`` state dict -> pretraining-model state
    dict (encoder and decoder)."""
    out = {"encoder." + k: x for k, x in videomae_from_hf_state_dict(sd, cfg).items()}
    out.update(_blocks_from_hf(sd, "decoder.decoder_layers.", "decoder.layers.",
                               cfg.decoder_depth))
    out["enc_to_dec.weight"] = _f32(sd["encoder_to_decoder.weight"])
    out["mask_token"] = _f32(sd["mask_token"])
    for ours, theirs in (("decoder_norm", "decoder.norm"), ("decoder_head", "decoder.head")):
        out[ours + ".weight"] = _f32(sd[theirs + ".weight"])
        out[ours + ".bias"] = _f32(sd[theirs + ".bias"])
    return out


def videomae_pretrain_to_hf_state_dict(sd: dict, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """Pretraining-model state dict -> HF ``VideoMAEForPreTraining`` state
    dict (f32 CPU tensors), the layout of the reference's checkpoints."""
    w = _f32(sd["encoder.patch_embed.weight"])
    out = {"videomae.embeddings.patch_embeddings.projection.weight": w.reshape(
               w.shape[0], cfg.in_channels, cfg.tubelet_size, cfg.patch_size,
               cfg.patch_size).contiguous(),
           "videomae.embeddings.patch_embeddings.projection.bias":
               _f32(sd["encoder.patch_embed.bias"])}
    out.update(_blocks_to_hf(sd, "encoder.blocks.layers.", "videomae.encoder.layer.",
                             cfg.depth))
    out.update(_blocks_to_hf(sd, "decoder.layers.", "decoder.decoder_layers.",
                             cfg.decoder_depth))
    out["encoder_to_decoder.weight"] = _f32(sd["enc_to_dec.weight"])
    out["mask_token"] = _f32(sd["mask_token"])
    for ours, theirs in (("decoder_norm", "decoder.norm"), ("decoder_head", "decoder.head")):
        out[theirs + ".weight"] = _f32(sd[ours + ".weight"])
        out[theirs + ".bias"] = _f32(sd[ours + ".bias"])
    return out


def qkv_key_biases(sd: dict) -> dict[str, torch.Tensor]:
    """The k thirds of the fused qkv biases of a state dict (``{name: k
    third}``, f32 CPU), which the HF layout cannot hold.  Mathematically
    their gradient is zero (a bias on every key adds the same amount to a
    query's scores), but in floating point they drift from 0; a checkpoint
    that keeps them resumes bit for bit."""
    out = {}
    for name, b in sd.items():
        if name.endswith("qkv.bias"):
            d = b.shape[0] // 3
            out[name] = _f32(b[d:2 * d]).clone()
    return out


def with_qkv_key_biases(sd: dict[str, torch.Tensor], k_biases: dict[str, torch.Tensor]
                        ) -> dict[str, torch.Tensor]:
    """``sd`` with the k thirds of its qkv biases replaced by ``k_biases``
    (the output of :func:`qkv_key_biases`)."""
    sd = dict(sd)
    for name, k in k_biases.items():
        b = sd[name].clone()
        d = b.shape[0] // 3
        b[d:2 * d] = k
        sd[name] = b
    return sd


def jepa_encoder_from_jax_params(tree: dict, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """JAX ``jepa.init_encoder_params``-shaped tree -> encoder state dict."""
    return {**_linear(tree["patch_embed"], "patch_embed."),
            **_blocks(tree["blocks"], cfg.depth, "blocks."),
            "norm.weight": _f32(tree["norm"]["scale"]),
            "norm.bias": _f32(tree["norm"]["bias"])}


def vit_image_from_jax_params(tree: dict, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """JAX ``vit_image.init_params``-shaped tree -> :class:`ImageViT` state
    dict; the tree has the JEPA encoder's layout."""
    return jepa_encoder_from_jax_params(tree, cfg)


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


_REF_BLOCK = (("ln1", "norm1"), ("qkv", "attn.qkv"), ("proj", "attn.proj"),
              ("ln2", "norm2"), ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2"))


def _ref_blocks(sd: dict, src_prefix: str, dst_prefix: str, depth: int, to_ref: bool
                ) -> dict[str, torch.Tensor]:
    """Reference ViT block entries ``{src_prefix}{i}.{norm1,attn.qkv,...}``
    <-> ``Blocks`` entries (``to_ref`` picks the direction; the prefixes
    are the source's and the destination's)."""
    out = {}
    for i in range(depth):
        for ours, theirs in _REF_BLOCK:
            src, dst = (ours, theirs) if to_ref else (theirs, ours)
            for leaf in ("weight", "bias"):
                out[f"{dst_prefix}{i}.{dst}.{leaf}"] = _f32(sd[f"{src_prefix}{i}.{src}.{leaf}"])
    return out


def jepa_encoder_from_reference_state_dict(sd: dict, cfg: ModelConfig
                                           ) -> dict[str, torch.Tensor]:
    """Reference ``VisionTransformer.state_dict()`` (``patch_embed.proj``
    as a Conv3d ``[D, C, ts, p, p]``, ``blocks.{i}.{norm1,attn.qkv,
    attn.proj,norm2,mlp.fc1,mlp.fc2}``, ``norm``) -> encoder state dict."""
    proj = _f32(sd["patch_embed.proj.weight"])
    return {"patch_embed.weight": proj.reshape(proj.shape[0], -1),
            "patch_embed.bias": _f32(sd["patch_embed.proj.bias"]),
            "norm.weight": _f32(sd["norm.weight"]), "norm.bias": _f32(sd["norm.bias"]),
            **_ref_blocks(sd, "blocks.", "blocks.layers.", cfg.depth, to_ref=False)}


def jepa_predictor_from_reference_state_dict(sd: dict, cfg: ModelConfig
                                             ) -> dict[str, torch.Tensor]:
    """Reference ``VisionTransformerPredictor.state_dict()`` -> predictor
    state dict (``predictor_pos_embed`` is recomputed, not read)."""
    out = {"mask_token": _f32(sd["mask_token"]),
           **_ref_blocks(sd, "predictor_blocks.", "blocks.layers.", cfg.pred_depth,
                         to_ref=False)}
    for ours, theirs in (("embed", "predictor_embed"), ("norm", "predictor_norm"),
                         ("proj", "predictor_proj")):
        out[ours + ".weight"] = _f32(sd[theirs + ".weight"])
        out[ours + ".bias"] = _f32(sd[theirs + ".bias"])
    return out


def _pos_table(cfg: ModelConfig, dim: int) -> torch.Tensor:
    g = cfg.image_size // cfg.patch_size
    table = positional_encoding_3d(cfg.num_frames // cfg.tubelet_size, g, g, dim)
    return torch.from_numpy(np.ascontiguousarray(table))[None]


def _pos_entry(name: str, cfg: ModelConfig, dim: int) -> dict[str, torch.Tensor]:
    """The fixed table under ``name``; none with rotary positions (V-JEPA
    2's networks hold no table)."""
    return {} if cfg.pos_embed == "rope3d" else {name: _pos_table(cfg, dim)}


def jepa_encoder_to_reference(sd: dict, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """Encoder state dict -> reference ``VisionTransformer.state_dict()``
    layout, with the fixed ``pos_embed`` table (none for ``rope3d``)."""
    w = _f32(sd["patch_embed.weight"])
    return {"patch_embed.proj.weight": w.reshape(w.shape[0], cfg.in_channels,
                                                 cfg.tubelet_size, cfg.patch_size,
                                                 cfg.patch_size).contiguous(),
            "patch_embed.proj.bias": _f32(sd["patch_embed.bias"]),
            **_pos_entry("pos_embed", cfg, w.shape[0]),
            "norm.weight": _f32(sd["norm.weight"]), "norm.bias": _f32(sd["norm.bias"]),
            **_ref_blocks(sd, "blocks.layers.", "blocks.", cfg.depth, to_ref=True)}


def jepa_predictor_to_reference(sd: dict, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """Predictor state dict -> reference
    ``VisionTransformerPredictor.state_dict()`` layout, with the fixed
    ``predictor_pos_embed`` table (none for ``rope3d``)."""
    out = {"mask_token": _f32(sd["mask_token"]),
           **_pos_entry("predictor_pos_embed", cfg, cfg.pred_emb_dim),
           **_ref_blocks(sd, "blocks.layers.", "predictor_blocks.", cfg.pred_depth,
                         to_ref=True)}
    for ours, theirs in (("embed", "predictor_embed"), ("norm", "predictor_norm"),
                         ("proj", "predictor_proj")):
        out[theirs + ".weight"] = _f32(sd[ours + ".weight"])
        out[theirs + ".bias"] = _f32(sd[ours + ".bias"])
    return out


def _bn_entries(prefix: str, p: dict, s: dict) -> dict[str, torch.Tensor]:
    return {prefix + "weight": _f32(p["scale"]), prefix + "bias": _f32(p["bias"]),
            prefix + "running_mean": _f32(s["mean"]), prefix + "running_var": _f32(s["var"]),
            prefix + "num_batches_tracked": torch.zeros((), dtype=torch.int64)}


def _oihw(w: Any) -> torch.Tensor:
    return _f32(w).permute(3, 2, 0, 1).contiguous()


def resnet_from_jax_params(params: dict, stats: dict, arch: str) -> dict[str, torch.Tensor]:
    """JAX ``resnet.init_params``-shaped ``(params, batch_stats)`` ->
    :class:`~bvc_tpu_torch.models.resnet.ResNet` state dict."""
    from bvc_tpu_torch.models.resnet import BLOCKS

    kind, reps = BLOCKS[arch]
    sd = {"conv1.weight": _oihw(params["stem"]["conv"]),
          **_bn_entries("bn1.", params["stem"]["bn"], stats["stem"])}
    n_convs = 3 if kind == "bottleneck" else 2
    for s in range(len(reps)):
        for b, (bp, bs) in enumerate(zip(params[f"stage{s}"], stats[f"stage{s}"])):
            pre = f"layer{s + 1}.{b}."
            for c in range(1, n_convs + 1):
                sd[f"{pre}conv{c}.weight"] = _oihw(bp[f"conv{c}"])
                sd.update(_bn_entries(f"{pre}bn{c}.", bp[f"bn{c}"], bs[f"bn{c}"]))
            if "down_conv" in bp:
                sd[pre + "downsample.0.weight"] = _oihw(bp["down_conv"])
                sd.update(_bn_entries(pre + "downsample.1.", bp["down_bn"], bs["down_bn"]))
    for ours, theirs in (("fc.0.", "fc1"), ("fc.2.", "fc2")):
        sd.update(_linear(params["head"][theirs], ours))
    return sd


def _export(x: Any) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x.detach()
    if t.dtype == torch.int64:  # num_batches_tracked
        return t.to("cpu").clone()
    return t.to("cpu", torch.float32).contiguous()


def resnet_to_torchvision_state_dict(sd: dict) -> dict[str, torch.Tensor]:
    """:class:`~bvc_tpu_torch.models.resnet.ResNet` state dict -> the export
    layout (torchvision names with the ``fc = Sequential(Linear, ReLU,
    Linear)`` head): every tensor on the CPU, contiguous, f32 but the int64
    ``num_batches_tracked``."""
    return {k: _export(v) for k, v in sd.items()}


def resnet_from_torchvision_state_dict(sd: dict) -> dict[str, torch.Tensor]:
    """The export layout (tensors or numpy arrays) ->
    :class:`~bvc_tpu_torch.models.resnet.ResNet` state dict."""
    return {k: _export(v) for k, v in sd.items()}
