"""mfu.train: the whole train step's share of the card's dense bf16 peak:
the plain model's forward FLOPs an image x 3 (forward and backward) x the
images trained in the window, over the window's seconds and the peak
(``peaks.json``). Layer: the whole step."""
TRAIN_FACTOR = 3


def read(ctx):
    w, c = ctx.window, ctx.counts
    if not w.get('images') or c is None:
        return None
    flops = c.forward_flops_per_image * TRAIN_FACTOR * w['images']
    return 100.0 * flops / w['seconds'] / ctx.peaks['bf16_dense_flops']
