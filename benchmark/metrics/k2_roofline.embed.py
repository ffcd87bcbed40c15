"""k2_roofline.embed: K2's byte bound at its shape over its mean device
time a call (``attention_pool`` kernels in the profiled stretch).

The bytes, as ``k2_bench.py`` counts them: the feature map read once at
the width the kernel's name shows (``bfloat16`` in the template
arguments, else float32), the K+1 pixel logits read once at the
configuration's compute width, and the float32 outputs written once (the
pooled sums ``[N, K+1, D]``, the attention sums and maxima ``[N, K+1]``).
The map's shape is the plain model's. The bound is the bytes at the
card's memory rate (``peaks.json``). Layer: the kernels
(``ops/cuda/attention_pool.cu``)."""
import re

K2 = re.compile(r'attention_pool')
WIDTH = {'bfloat16': 2, 'float16': 2, 'float32': 4}


def read(ctx):
    t, c = ctx.traced, ctx.counts
    if t is None or c is None:
        return None
    names = t.device_names(K2)
    if not names:
        return None
    n, d, h, w = c.feature_map
    k1 = ctx.cell.config['model']['parts_num'] + 1
    feat = 2 if 'bfloat16' in names[0].lower() else 4
    nbytes = (n * d * h * w * feat
              + n * k1 * h * w * WIDTH[ctx.cell.config['model']
                                       ['compute_dtype']]
              + (n * k1 * d + 2 * n * k1) * 4)
    bound_s = nbytes / ctx.peaks['hbm_bytes_per_s']
    return 100.0 * bound_s / (t.device_us(K2) / len(names) / 1e6)
