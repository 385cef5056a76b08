"""The whole step's share of the card's dense bf16 peak (989 TFLOP/s): the
FLOP model (``benchlib/flops.py``) at each image's proposal bucket and
sentence count, summed over the window's images, over the window, percent."""

PEAK = 989e12


def read(run):
    if not run.images or run.window_s <= 0:
        return None
    return 100.0 * sum(run.flops) / run.window_s / PEAK
