"""Models, the whole call: the frozen operations of a VideoMAE embed a clip
times the (untraced) window's clips a second, as a percent of the bf16 peak."""

from portbench import arith, readers


def read(view):
    flops = arith.embed_flops_per_clip(view.model) * readers.clips_per_s_per_card(view)
    return 100.0 * flops / arith.PEAK_BF16_FLOPS
