"""optim_roofline.train: the least time a train step's amsgrad update
needs, over the device time a step of the optimizer's kernels.

The least time is 36 bytes (``grouped_counts.AMSGRAD_BYTES``: p, g, mu,
nu and nu_max read, p, mu, nu and nu_max written, float32) a trainable
element of the plain model (``grouped_counts.trainable_elements``) at
the card's memory rate (``peaks.json``). The kernels are PyTorch's
``multi_tensor_apply_kernel`` instances, by name: in the traced step of
``train.osnet_x1_0`` on the H100 all 66 of them a step are the
``torch._foreach_*`` calls of ``OptaxRule._update`` (functors
``BinaryOpListAlphaFunctor`` plus, divides and maximum,
``BinaryOpScalarTensorFunctor`` divides by the bias corrections,
``BinaryOpScalarFunctor`` multiplies and plus, ``PointwiseOpScalarFunctor``
for ``addcmul``, ``UnaryOpFunctor`` sqrt); the engine's ``zero_grad``
fills each gradient with its own kernel, not a ``_foreach`` one. The
bytes are amsgrad's alone, so a cell whose configuration trains with
another optimizer reads nothing. Layer: the optimizer
(``optim/optimizer.py``)."""
import re

from benchmark.grouped_counts import AMSGRAD_BYTES, trainable_elements

OPTIM_KERNELS = re.compile(r'multi_tensor_apply_kernel')


def read(ctx):
    t = ctx.traced
    if ctx.cell.config.get('optim', {}).get('name') != 'amsgrad':
        return None
    if t is None or not t.steps or not t.device_names(OPTIM_KERNELS):
        return None
    n = trainable_elements(ctx.cell.config, ctx.cell.root)
    bound_s = AMSGRAD_BYTES * n / ctx.peaks['hbm_bytes_per_s']
    return 100.0 * bound_s / (t.device_us(OPTIM_KERNELS) / t.steps / 1e6)
