"""Counts of the work a cell's step asks for, taken once from the
benchmark's plain reference model on the meta device (no memory, no
arithmetic): the model FLOPs of a forward pass (``FlopCounterMode``:
convolutions and matrix products, 2 per multiply-add), each batch norm's
input shape and whether the loss sends it a gradient, and the shape of
the feature map the parts are pooled from. The per-layer metric readers
turn them into bounds, so the bounds count the same work whatever the
program runs to do it."""
import torch

from benchmark.reference import model as ref_model
from benchmark.reference import train as ref_train

__all__ = ['ModelCounts', 'model_counts']


class ModelCounts:
    def __init__(self, batch, flops, bns, feature_map):
        self.batch = batch
        self.forward_flops_per_image = flops / batch
        # [(module name, input shape, gets a gradient)]
        self.bns = bns
        self.feature_map = feature_map


def model_counts(config, workload):
    """The counts of one step of ``workload`` (traffic ``train``: the
    train-mode forward and which batch norms the loss reaches; else the
    eval forward)."""
    from torch.utils.flop_counter import FlopCounterMode
    m = config['model']
    n = int(workload['ids']) * int(workload['instances'])
    train = workload['traffic'] == 'train'
    model = ref_model.build(config, 'meta')
    model.train(train)
    seen = []

    def hook(name):
        def record(_module, inputs, output):
            seen.append((name, tuple(inputs[0].shape), output))
        return record

    handles = [mod.register_forward_hook(hook(name))
               for name, mod in model.named_modules()
               if isinstance(mod, ref_model.BN)]
    trunk = model.backbone_appearance_feature_extractor
    maps = []
    handles.append(trunk.register_forward_hook(
        lambda _m, _i, out: maps.append(tuple(out.shape))))
    x = torch.zeros(n, 3, m['height'], m['width'], device='meta')
    with FlopCounterMode(display=False) as counter:
        out = model(x)
    for h in handles:
        h.remove()
    grads = [False] * len(seen)
    if train:
        s = config['masks']['mask_scale']
        masks = torch.zeros(n, m['parts_num'] + 1, m['height'] // s,
                            m['width'] // s, device='meta')
        pids = torch.zeros(n, dtype=torch.int64, device='meta')
        loss, _ = ref_train.gilt_loss(out, masks, pids,
                                   config['loss']['weights'],
                                   config['loss']['margin'])
        got = torch.autograd.grad(loss, [o for _, _, o in seen],
                                  allow_unused=True)
        grads = [g is not None for g in got]
    bns = [(name, shape, g) for (name, shape, _), g in zip(seen, grads)]
    return ModelCounts(n, counter.get_total_flops(), bns, maps[0])
