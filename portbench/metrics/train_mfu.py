"""Models, the whole step: the window's model operations a second on a card
(the frozen count of a step's operations a clip, V-JEPA's over the tokens
each batch keeps, times the window's clips a second a card) as a percent of
the bf16 peak, 989 TFLOP/s.  The window is the untraced one of the
``--trace 1`` run, as long as the end-to-end run's."""

from portbench import arith, readers


def read(view):
    flops = readers.step_flops_per_clip(view) * readers.clips_per_s_per_card(view)
    return 100.0 * flops / arith.PEAK_BF16_FLOPS
