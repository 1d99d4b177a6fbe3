"""Models, the whole V-JEPA 2 step: the window's model operations a second
on a card (``portbench/arith_rope.py``'s count a clip, each MLP at its own
width, over the context and target tokens each batch keeps, times the
window's clips a second a card) as a percent of the bf16 peak, 989 TFLOP/s.
The window is the untraced one of the ``--trace 1`` run.  None for a cell
whose masks are not V-JEPA's 3-D ones (the count takes one prediction
mask)."""

import statistics

from portbench import arith, arith_rope, readers


def read(view):
    outs = view.window["metrics_out"]
    if view.config["mask"].get("sampler") != "multiblock3d" or not outs:
        return None
    per_clip = statistics.fmean(arith_rope.vjepa2_train_flops_per_clip(
        view.model, int(o["mask_a"]), int(o["mask_b"])) for o in outs)
    return 100.0 * per_clip * readers.clips_per_s_per_card(view) / arith.PEAK_BF16_FLOPS
