"""Model factory (port of bpbreid_tpu/models/__init__.py:118).

Ported: ``bpbreid`` (HRNet-W32 or ResNet backbone), its PCB and BoT
forms ``pcb`` and ``bot`` (horizontal stripes), ``hrnet32`` and the
ResNet family (``resnet18`` ... ``resnet50_fc512``); every other
registry name raises. ``build_model`` puts the model on
``device`` (default ``'cuda'``, raising when CUDA is missing) in eval
mode, with weights drawn from ``seed`` by an explicit
``torch.Generator`` (flax's default initializers).
"""
import torch

from bpbreid_tpu_torch import resolve_device
from bpbreid_tpu_torch.models.common import init_parameters
from bpbreid_tpu_torch.models.resnet import RESNETS

__all__ = ['build_model']

PORTED = ('bpbreid', 'pcb', 'bot', 'hrnet32') + tuple(RESNETS)


def build_model(name, num_classes, loss='part_based', pretrained=False,
                device=None, seed=0, **kwargs):
    """Build a ported model by registry name.

    Args:
        name: 'bpbreid', 'pcb' or 'bot' (each needs ``config=``; 'pcb'
            and 'bot' set fields of it, as in JAX), 'hrnet32' or a
            ResNet.
        device: torch device; ``None`` means ``'cuda'``.
        seed: seed of the ``torch.Generator`` that draws the weights.
    Returns:
        the ``nn.Module`` on ``device``, in eval mode.
    """
    if name not in PORTED:
        raise NotImplementedError(
            "model '{}' is not ported yet (ported: {})".format(
                name, ', '.join(PORTED)))
    device = resolve_device(device)
    if name in ('bpbreid', 'pcb', 'bot'):
        from bpbreid_tpu_torch.models import bpbreid as bpbreid_module
        model = getattr(bpbreid_module, name)(
            num_classes, loss=loss, pretrained=pretrained, **kwargs)
    elif name == 'hrnet32':
        from bpbreid_tpu_torch.models.hrnet import hrnet32
        model = hrnet32(num_classes, loss=loss, pretrained=pretrained,
                        **kwargs)
    else:
        model = RESNETS[name](num_classes, loss=loss, pretrained=pretrained,
                              **kwargs)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
