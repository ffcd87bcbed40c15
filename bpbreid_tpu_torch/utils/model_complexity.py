"""Model complexity: parameter count and FLOPs (port of
bpbreid_tpu/utils/model_complexity.py; the reference counts both with
forward hooks, torchreid/utils/model_complexity.py:264-330).

The parameters are those that the eval-mode forward reads (each
``nn.Parameter`` fetched from its module while it runs, counted once),
without the BN running statistics: what JAX counts, the ``params``
collection of an eval-mode ``init`` (flax creates the parameters that a
call reaches, so a classifier used only in training has none). The
FLOPs are
``torch.utils.flop_counter.FlopCounterMode``'s count of one eval-mode
forward at batch 1: two per multiply-add of the convolutions and matrix
products, nothing for elementwise work or for the port's hand-written
kernels (launched through ``ctypes``). JAX reads XLA's cost analysis of
the compiled forward, which counts elementwise work too, so the two
counts differ (a divergence kept on purpose, ROADMAP). BPBReID gets
dummy masks beside the image, as the reference feeds it.
"""
import torch
from torch import nn

__all__ = ['compute_model_complexity']


@torch.no_grad()
def compute_model_complexity(model, cfg=None, height=None, width=None,
                             verbose=False):
    """Returns ``(num_params, flops)`` of one forward at batch size 1 on
    the model's device; the model's train/eval mode is restored."""
    from torch.utils.flop_counter import FlopCounterMode

    from bpbreid_tpu_torch.models.bpbreid import BPBreID
    h = height or (cfg.data.height if cfg is not None else 256)
    w = width or (cfg.data.width if cfg is not None else 128)
    device = next(model.parameters()).device
    args = [torch.zeros((1, 3, h, w), device=device)]
    if isinstance(model, BPBreID):
        args.append(torch.ones((1, model.parts_num + 1, max(1, h // 8),
                                max(1, w // 8)), device=device))
    # a module's parameters are not in its __dict__: every read of one
    # goes through nn.Module.__getattr__, recorded here for the forward
    read = {}
    module_getattr = nn.Module.__getattr__

    def recording_getattr(module, name):
        value = module_getattr(module, name)
        if isinstance(value, nn.Parameter):
            read[id(value)] = value.numel()
        return value
    was_training = model.training
    model.eval()
    counter = FlopCounterMode(display=False)
    nn.Module.__getattr__ = recording_getattr
    try:
        with counter:
            model(*args)
    finally:
        nn.Module.__getattr__ = module_getattr
        model.train(was_training)
    num_params, flops = sum(read.values()), int(counter.get_total_flops())
    if verbose:
        print('Model complexity: params={:,} flops={:,}'.format(
            num_params, flops))
    return num_params, flops
