"""Model factory (port of bpbreid_tpu/models/__init__.py:118).

Ported: ``bpbreid`` (on any backbone below), its PCB and BoT forms
``pcb`` and ``bot`` (horizontal stripes), ``hrnet32``, the ResNet family
(``resnet18`` ... ``resnet50_fc512``), the OSNets (``osnet_x1_0``,
``osnet_x0_75``, ``osnet_x0_5``, ``osnet_x0_25``, ``osnet_ibn_x1_0``,
``osnet_ain_x1_0``), the IBN-Net ResNets (``resnet50_ibn_a``,
``resnet50_ibn_b``), ``resnet50mid`` and the fastreid trunks
(``fastreid_resnet``, ``_ibn``, ``_nl``, ``_ibn_nl``: feature maps for
BPBReID); every other registry name raises. ``build_model`` puts the
model on ``device`` (default ``'cuda'``, raising when CUDA is missing)
in eval mode, with weights drawn from ``seed`` by an explicit
``torch.Generator`` (flax's default initializers).
"""
import torch

from bpbreid_tpu_torch import resolve_device
from bpbreid_tpu_torch.models import osnet, resnet_fastreid, resnet_ibn
from bpbreid_tpu_torch.models.common import init_parameters
from bpbreid_tpu_torch.models.hrnet import hrnet32
from bpbreid_tpu_torch.models.resnet import RESNETS
from bpbreid_tpu_torch.models.resnetmid import resnet50mid

__all__ = ['BACKBONES', 'PORTED', 'build_model']

# every ported registry name but the BPBReID family: each constructor
# takes (num_classes, loss=..., pretrained=..., dtype=..., **kwargs) and
# ignores the other arguments (BPBReID's backbone arguments) it has no
# use for
BACKBONES = dict(
    hrnet32=hrnet32, **RESNETS,
    **{name: getattr(osnet, name) for name in osnet.__all__
       if name.startswith('osnet_')},
    resnet50_ibn_a=resnet_ibn.resnet50_ibn_a,
    resnet50_ibn_b=resnet_ibn.resnet50_ibn_b,
    resnet50mid=resnet50mid,
    **{name: getattr(resnet_fastreid, name)
       for name in resnet_fastreid.__all__ if name.startswith('fastreid_')})

BPBREID_FAMILY = ('bpbreid', 'pcb', 'bot')
PORTED = BPBREID_FAMILY + tuple(BACKBONES)


def build_model(name, num_classes, loss='part_based', pretrained=False,
                device=None, seed=0, **kwargs):
    """Build a ported model by registry name.

    Args:
        name: 'bpbreid', 'pcb' or 'bot' (each needs ``config=``; 'pcb'
            and 'bot' set fields of it, as in JAX), or a name of
            ``BACKBONES`` (with ``config=``, its ``model.compute_dtype``
            unless ``dtype=`` is given).
        device: torch device; ``None`` means ``'cuda'``.
        seed: seed of the ``torch.Generator`` that draws the weights.
    Returns:
        the ``nn.Module`` on ``device``, in eval mode.
    """
    if name not in BPBREID_FAMILY and name not in BACKBONES:
        raise NotImplementedError(
            "model '{}' is not ported yet (ROADMAP Queue 1 item 9; ported: "
            "{})".format(name, ', '.join(PORTED)))
    device = resolve_device(device)
    if name in BPBREID_FAMILY:
        from bpbreid_tpu_torch.models import bpbreid as bpbreid_module
        model = getattr(bpbreid_module, name)(
            num_classes, loss=loss, pretrained=pretrained, **kwargs)
    else:
        config = kwargs.pop('config', None)
        if config is not None and 'dtype' not in kwargs:
            # JAX's zoo models compute in f32 whatever the config says;
            # the port's take model.compute_dtype, as BPBReID does
            kwargs['dtype'] = torch.bfloat16 \
                if config.model.compute_dtype == 'bfloat16' \
                else torch.float32
        model = BACKBONES[name](num_classes, loss=loss,
                                pretrained=pretrained, **kwargs)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
