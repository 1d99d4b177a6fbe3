"""Models, the whole Hiera MAE step: the window's model operations a second
on a card (``portbench/arith_hiera.py``'s count a clip at the cell's mask
ratio, every stage, the fusion heads and the decoder at their own widths,
times the window's clips a second a card) as a percent of the bf16 peak,
989 TFLOP/s.  The window is the untraced one of the ``--trace 1`` run.
None for a cell whose model is not Hiera."""

from portbench import arith, arith_hiera, readers


def read(view):
    if view.model.get("architecture") != "hiera":
        return None
    per_clip = arith_hiera.hiera_train_flops_per_clip(view.model,
                                                      view.config["mask"]["mask_ratio"])
    return 100.0 * per_clip * readers.clips_per_s_per_card(view) / arith.PEAK_BF16_FLOPS
