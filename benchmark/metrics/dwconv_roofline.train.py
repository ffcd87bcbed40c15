"""dwconv_roofline.train: the least time a train step's grouped
(depthwise) convolutions need, over the device time a step of the
kernels that compute them.

The least time is their bytes at the card's memory rate
(``peaks.json``), counted on the plain model
(``benchmark/grouped_counts.py``): each ``layers.Conv`` with ``groups``
above 1 at the cell's batch, forward, data gradient and weight gradient
each reading and writing the input- and output-sized tensors once at the
configuration's compute width. The kernels are PyTorch's own depthwise
kernels by name (``conv_depthwise2d_forward_kernel``,
``conv_depthwise2d_backward_kernel``,
``conv_depthwise2d_grad_weight_kernel``): at bfloat16 PyTorch sends a
depthwise convolution to them and not to cuDNN, and no other grouped
convolution runs in the cells that list this metric. Layer: the kernels
the models launch (``models/osnet.py``)."""
import re

from benchmark.grouped_counts import conv_bound_bytes, grouped_convs

DW_KERNELS = re.compile(r'conv_depthwise2d')
WIDTH = {'bfloat16': 2, 'float16': 2, 'float32': 4}


def read(ctx):
    t = ctx.traced
    if t is None or not t.steps or not t.device_names(DW_KERNELS):
        return None
    cell = ctx.cell
    convs = grouped_convs(cell.config, cell.workload, cell.root)
    if not convs:
        return None
    width = WIDTH[cell.config['model']['compute_dtype']]
    bound_s = conv_bound_bytes(convs, width) / ctx.peaks['hbm_bytes_per_s']
    return 100.0 * bound_s / (t.device_us(DW_KERNELS) / t.steps / 1e6)
