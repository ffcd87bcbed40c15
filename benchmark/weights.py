"""Seeded weights for both sides of a comparison, made on the device in
a few large calls.

Every leaf of the reference model's state dict gets a value: convolution
and linear weights ``N(0, 1/fan_in)`` (LeCun normal), batch-norm scales
``1 + 0.1 N(0, 1)``, biases ``0.05 N(0, 1)``, running means
``0.1 N(0, 1)`` and running variances ``exp(0.2 N(0, 1))``. One normal
draw of the total size feeds them all, in the order of the sorted names,
so a seed gives the same weights on every run. ``calibrate_bn`` then
replaces the running statistics by those of the reference model on a
batch of crops, as a trained model's would match its inputs.

The last batch norm of each residual branch (the reference module's
``ends_residual``, by default ``_ends_residual``'s naming of ResNet and
HRNet blocks) has its scale times ``RESIDUAL_SCALE`` (0.1;
zero-init-residual training starts it at 0):
with unit scales the random network is chaotic, so that a 1e-3 change
of its input moves HRNet-W32's features by 20 % and ResNet-50's by 30 %
(float32, 128x64 crops), and bf16 rounding alone by more; at 0.1, by
1.6 % and 0.8 %, closer to a trained network, where a lower precision
shows against the program's own rounding.
"""
import math

import torch

__all__ = ['make_weights', 'calibrate_bn', 'RESIDUAL_SCALE']

RESIDUAL_SCALE = 0.1


def _ends_residual(name, shapes):
    """Whether ``name`` is the scale of the last batch norm of a residual
    branch: ``bn3`` of a bottleneck, ``bn2`` of a basic block (one without
    a ``bn3``), the blocks being numbered members of a layer)."""
    prefix, bn, _ = name.rsplit('.', 2) if name.count('.') >= 2 \
        else ('', '', '')
    if not prefix.rsplit('.', 1)[-1].isdigit():
        return False
    return bn == 'bn3' or (bn == 'bn2'
                           and prefix + '.bn3.weight' not in shapes)


def make_weights(shapes, seed, device, reference=None):
    """``{name: tensor}`` (float32 on ``device``) for ``shapes``
    (``{name: shape}``) from ``seed``; the residual branches' ends by the
    ``reference`` module's ``ends_residual`` where it gives one."""
    ends_residual = getattr(reference, 'ends_residual', _ends_residual)
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    g = torch.Generator(device=device).manual_seed(int(seed))
    z = torch.randn(sum(sizes), generator=g, device=device)
    out, at = {}, 0
    for name, size in zip(names, sizes):
        v = z[at:at + size].view(shapes[name])
        at += size
        last = name.rsplit('.', 1)[-1]
        if len(shapes[name]) >= 2:
            v = v * (1.0 / math.sqrt(size / shapes[name][0]))
        elif last == 'weight':
            v = (1.0 + 0.1 * v) * (RESIDUAL_SCALE
                                   if ends_residual(name, shapes) else 1.0)
        elif last == 'bias':
            v = 0.05 * v
        elif last == 'running_mean':
            v = 0.1 * v
        elif last == 'running_var':
            v = torch.exp(0.2 * v)
        else:
            raise ValueError('no rule for the weight {}'.format(name))
        out[name] = v
    return out


@torch.no_grad()
def calibrate_bn(model, images):
    """Set every batch norm's running statistics of the reference
    ``model`` to the batch statistics it meets on ``images`` (one forward
    in train mode, momentum 1). Returns the new running statistics."""
    from benchmark.reference.layers import BN
    bns = [m for m in model.modules() if isinstance(m, BN)]
    for m in bns:
        m.momentum = 1.0
    model.train()
    model(images)
    model.eval()
    for m in bns:
        m.momentum = 0.1
    return {k: v.clone() for k, v in model.state_dict().items()
            if k.endswith(('running_mean', 'running_var'))}
