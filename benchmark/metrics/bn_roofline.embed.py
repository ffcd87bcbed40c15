"""bn_roofline.embed: the least time an eval batch's batch norms need,
over the device time of every kernel that does batch norm in the batch.

The least time is the bytes of the plain model's eval-mode batch norms at
the card's memory rate (``peaks.json``): each input read once and each
output written once at the configuration's compute width, the scale,
shift and running statistics read in float32. The pixel classifier's
batch norm is left out: the program folds it into the classifier's plain
operations, and no batch-norm kernel runs for it. The kernels are the
port's ``bn_stats.cu`` kernels and any library batch norm, by name.
Layer: the kernels (``ops/cuda/bn_stats.cu``)."""
import math
import re

BN_KERNELS = re.compile(r'reduce_rows_kernel|reduce_cols_kernel|'
                        r'ewise_rows_kernel|ewise_cols_kernel|'
                        r'batch_?norm|bn_fw|bn_bw')
WIDTH = {'bfloat16': 2, 'float16': 2, 'float32': 4}
LEFT_OUT = ('pixel_classifier.',)


def bound_bytes(bns, width):
    total = 0
    for name, shape, _grad in bns:
        if name.startswith(LEFT_OUT):
            continue
        n, c = math.prod(shape), shape[-1] if len(shape) < 4 else shape[1]
        total += 2 * n * width + 4 * c * 4
    return total


def read(ctx):
    t, c = ctx.traced, ctx.counts
    if t is None or c is None or not t.steps or not t.device_names(
            BN_KERNELS):
        return None
    width = WIDTH[ctx.cell.config['model']['compute_dtype']]
    bound_s = bound_bytes(c.bns, width) / ctx.peaks['hbm_bytes_per_s']
    return 100.0 * bound_s / (t.device_us(BN_KERNELS) / t.steps / 1e6)
