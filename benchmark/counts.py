"""Counts of the work a cell's step asks for, taken once from the
configuration's plain reference (``benchmark/reference/__init__.py``) on
the meta device (no memory, no arithmetic): the model FLOPs of a forward
pass (``FlopCounterMode``: convolutions and matrix products, 2 per
multiply-add), each batch norm's input shape and whether the reference's
``counting_loss`` sends it a gradient, and the shape of the feature map
the parts are pooled from, where the reference names one. The per-layer
metric readers turn them into bounds, so the bounds count the same work
whatever the program runs to do it."""
import torch

from benchmark.core import ROOT, load_traffic
from benchmark.reference import reference_of
from benchmark.reference.layers import BN

__all__ = ['ModelCounts', 'model_counts']


class ModelCounts:
    def __init__(self, batch, flops, bns, feature_map):
        self.batch = batch
        self.forward_flops_per_image = flops / batch
        # [(module name, input shape, gets a gradient)]
        self.bns = bns
        # the pooled map's shape, None where the reference names no map
        self.feature_map = feature_map


def model_counts(config, workload, root=ROOT):
    """The counts of one step of ``workload``, a batch of ``ids`` x
    ``instances``: where its traffic kind trains (``TRAINS``), the
    train-mode forward and which batch norms the loss reaches; else the
    eval forward."""
    from torch.utils.flop_counter import FlopCounterMode
    m = config['model']
    n = int(workload['ids']) * int(workload['instances'])
    train = load_traffic(workload['traffic'], root).TRAINS
    ref = reference_of(config, root)
    model = ref.build(config, 'meta')
    model.train(train)
    seen = []

    def hook(name):
        def record(_module, inputs, output):
            seen.append((name, tuple(inputs[0].shape), output))
        return record

    handles = [mod.register_forward_hook(hook(name))
               for name, mod in model.named_modules() if isinstance(mod, BN)]
    maps = []
    if hasattr(ref, 'feature_map'):
        handles.append(ref.feature_map(model).register_forward_hook(
            lambda _m, _i, out: maps.append(tuple(out.shape))))
    x = torch.zeros(n, 3, m['height'], m['width'], device='meta')
    with FlopCounterMode(display=False) as counter:
        out = model(x)
    for h in handles:
        h.remove()
    grads = [False] * len(seen)
    if train:
        loss = ref.counting_loss(config, out, n, 'meta')
        got = torch.autograd.grad(loss, [o for _, _, o in seen],
                                  allow_unused=True)
        grads = [g is not None for g in got]
    bns = [(name, shape, g) for (name, shape, _), g in zip(seen, grads)]
    return ModelCounts(n, counter.get_total_flops(), bns,
                       maps[0] if maps else None)
