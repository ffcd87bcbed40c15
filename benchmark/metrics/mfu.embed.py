"""mfu.embed: the whole eval step's share of the card's dense bf16 peak:
the plain model's forward FLOPs an image x the crops embedded in the
window, over the window's seconds and the peak (``peaks.json``). Layer:
the whole step."""


def read(ctx):
    w, c = ctx.window, ctx.counts
    if not w.get('images') or c is None:
        return None
    flops = c.forward_flops_per_image * w['images']
    return 100.0 * flops / w['seconds'] / ctx.peaks['bf16_dense_flops']
