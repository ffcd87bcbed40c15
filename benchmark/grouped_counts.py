"""Counts of a train step's grouped convolutions and optimizer state,
taken once from the configuration's plain reference
(``benchmark/reference/__init__.py``) on the meta device (no memory, no
arithmetic), for the per-layer metrics that bound them by the card's
memory rate: ``dwconv_roofline.train`` (each ``layers.Conv`` with
``groups`` above 1: its name, input and output shape at the cell's
batch) and ``optim_roofline.train`` (the trainable float32 elements an
optimizer step updates)."""
import math

import torch

from benchmark.core import ROOT
from benchmark.reference import reference_of
from benchmark.reference.layers import Conv

__all__ = ['grouped_convs', 'conv_bound_bytes', 'trainable_elements',
           'AMSGRAD_BYTES']

# amsgrad reads p, g, mu, nu, nu_max and writes p, mu, nu, nu_max, each
# one float32 an element
AMSGRAD_BYTES = 9 * 4


def grouped_convs(config, workload, root=ROOT):
    """``[(module name, input shape, output shape)]`` of the reference's
    grouped convolutions (``groups`` > 1, the depthwise ones included) in
    a train-mode forward of a batch of ``ids`` x ``instances``."""
    m = config['model']
    n = int(workload['ids']) * int(workload['instances'])
    model = reference_of(config, root).build(config, 'meta')
    model.train()
    seen = []

    def hook(name):
        def record(_module, inputs, output):
            seen.append((name, tuple(inputs[0].shape), tuple(output.shape)))
        return record
    handles = [mod.register_forward_hook(hook(name))
               for name, mod in model.named_modules()
               if isinstance(mod, Conv) and mod.groups > 1]
    with torch.no_grad():
        model(torch.zeros(n, 3, m['height'], m['width'], device='meta'))
    for h in handles:
        h.remove()
    return seen


def conv_bound_bytes(convs, width):
    """The least bytes a train step of ``convs`` moves at ``width`` bytes
    an element: forward, the input read and the output written once;
    the data gradient, the output gradient read and the input gradient
    written; the weight gradient, the input and the output gradient read
    (the weights, 9 values a channel, left out)."""
    return sum(3 * (math.prod(x) + math.prod(y)) * width
               for _, x, y in convs)


def trainable_elements(config, root=ROOT):
    """The elements of the reference's trainable parameters."""
    model = reference_of(config, root).build(config, 'meta')
    return sum(p.numel() for p in model.parameters() if p.requires_grad)
