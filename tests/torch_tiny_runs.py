"""Tiny one-stage training configurations shared by the port's trainer,
checkpoint and CLI tests: the same fields set on the JAX package's
``TrainConfig`` and on the port's, over the ``frame_corpus`` fixture's
32x32 frames."""

from __future__ import annotations

VIDEOMAE_MODEL = dict(image_size=32, patch_size=8, num_frames=4, tubelet_size=2,
                      hidden_size=32, depth=2, num_heads=2, mlp_ratio=2.0,
                      decoder_hidden_size=16, decoder_depth=1, decoder_num_heads=2,
                      dtype="float32")
JEPA_MODEL = dict(family="jepa", image_size=32, patch_size=8, num_frames=2, tubelet_size=1,
                  hidden_size=32, depth=2, num_heads=2, mlp_ratio=2.0, pred_depth=1,
                  pred_emb_dim=16, dtype="float32")
SIMCLR_MODEL = dict(family="simclr", architecture="resnet18", image_size=32, num_frames=2,
                    tubelet_size=1, pred_emb_dim=16, dtype="float32")
MODELS = {"videomae": VIDEOMAE_MODEL, "jepa": JEPA_MODEL, "simclr": SIMCLR_MODEL}


def tiny_cfg(Cfg, family: str, frame_corpus: str, savedir: str, run_id: str,
             batch_size: int = 8, **top):
    """A ``Cfg`` (either package's ``TrainConfig``) for a 3-step stage of
    ``family`` on ``frame_corpus``; ``batch_size`` is per device."""
    cfg = Cfg(run_id=run_id, savedir=str(savedir), n_epoch=1, max_epoch_iters=3, seed=0,
              log_freq=1)
    d = cfg.data
    d.jpg_root, d.train_group, d.image_size = frame_corpus, "g0", 32
    d.n_trainsamples, d.batch_size, d.num_workers = 24, batch_size, 2
    d.segment_minutes, d.keep_val = 0.02, False
    for k, v in MODELS[family].items():
        setattr(cfg.model, k, v)
    d.num_frames, d.tubelet_size = cfg.model.num_frames, cfg.model.tubelet_size
    if family == "videomae":
        cfg.mask.mask_ratio = 0.75
        cfg.optim.lr = 0.01
    elif family == "simclr":
        # InfoNCE's gradient at init has norm near 190: a larger step makes
        # f32 rounding decide the trajectory (tests/test_torch_simclr.py)
        d.interval = 5
        cfg.optim.lr = 1e-4
    else:
        d.interval = 5
        cfg.mask.pred_mask_scale, cfg.mask.min_keep = (0.2, 0.25), 2
        cfg.optim.lr = 0.03
        cfg.optim.exclude_bias_and_norm_from_wd = True
    cfg.optim.weight_decay = 1e-4
    for k, v in top.items():
        setattr(cfg, k, v)
    return cfg


def shrink_videomae(cli_module) -> None:
    """Give the VideoMAE CLI module's parsed configs ``VIDEOMAE_MODEL``'s
    widths and patch 8 (the CLI has no width flags; frames and image size
    stay the flags')."""
    parse = cli_module.config_from_args

    def tiny(args):
        cfg = parse(args)
        for k, v in VIDEOMAE_MODEL.items():
            if k not in ("image_size", "num_frames", "tubelet_size", "patch_size"):
                setattr(cfg.model, k, v)
        cfg.model.patch_size = 8
        return cfg

    cli_module.config_from_args = tiny
