"""Model factory (port of bpbreid_tpu/models/__init__.py:118).

Every name of the JAX registry: ``bpbreid`` (on any backbone but those
of ``NO_FEATURE_MAP``), its PCB and BoT forms ``pcb`` and ``bot`` (horizontal
stripes), ``hrnet32``, the ResNet family (``resnet18`` ...
``resnet50_fc512``), the OSNets, the IBN-Net ResNets, ``resnet50mid``,
the fastreid trunks (feature maps for BPBReID), PCB (``pcb_p4``,
``pcb_p6``), PVPM (``pose_p4``, ``pose_p6``, ``pose_p4s``, ``pose_p6s``:
``forward(x, pose_map)``) and the legacy Torchreid zoo (SENet, DenseNet,
MobileNetV2, ShuffleNet and ShuffleNetV2, SqueezeNet, MLFN, Xception,
InceptionV4, Inception-ResNet-V2, NASNet-A Mobile, MuDeep, HACNN); a name
outside that registry raises ``NotImplementedError``. ``build_model``
puts the model on ``device`` (default ``'cuda'``, raising when CUDA is
missing) in eval mode, with weights drawn from ``seed`` by an explicit
``torch.Generator`` (flax's default initializers).
"""
import torch

from bpbreid_tpu_torch import resolve_device
from bpbreid_tpu_torch.models import (densenet, hacnn, inceptionresnetv2,
                                      inceptionv4, mlfn, mobilenetv2, mudeep,
                                      nasnet, osnet, pcb, pvpm,
                                      resnet_fastreid, resnet_ibn, senet,
                                      shufflenet, shufflenetv2, squeezenet,
                                      xception)
from bpbreid_tpu_torch.models.common import init_parameters
from bpbreid_tpu_torch.models.hrnet import hrnet32
from bpbreid_tpu_torch.models.resnet import RESNETS
from bpbreid_tpu_torch.models.resnetmid import resnet50mid

__all__ = ['BACKBONES', 'NO_FEATURE_MAP', 'PORTED', 'build_model',
           'show_avai_models', 'register_model']


def _constructors(module, prefix=''):
    return {name: getattr(module, name) for name in module.__all__
            if name.startswith(prefix) and name[0].islower()}

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
       for name in resnet_fastreid.__all__ if name.startswith('fastreid_')},
    pcb_p4=pcb.pcb_p4, pcb_p6=pcb.pcb_p6,
    **_constructors(pvpm, 'pose_'), **_constructors(senet, 'se'),
    **_constructors(densenet, 'densenet'),
    **_constructors(mobilenetv2, 'mobilenetv2_'),
    shufflenet=shufflenet.shufflenet,
    **_constructors(shufflenetv2, 'shufflenet_v2_'),
    **_constructors(squeezenet, 'squeezenet'), mlfn=mlfn.mlfn,
    xception=xception.xception, inceptionv4=inceptionv4.inceptionv4,
    inceptionresnetv2=inceptionresnetv2.inceptionresnetv2,
    nasnetamobile=nasnet.nasnetamobile, mudeep=mudeep.mudeep,
    hacnn=hacnn.hacnn)

# the registry names whose part-based call returns no feature map for
# BPBReID to pool: PCB and PVPM return pooled vectors, HACNN embeddings
NO_FEATURE_MAP = tuple(name for name in BACKBONES
                       if name.startswith(('pcb_', 'pose_', 'hacnn')))

BPBREID_FAMILY = ('bpbreid', 'pcb', 'bot')
PORTED = BPBREID_FAMILY + tuple(BACKBONES)


def show_avai_models():
    """The registry's names, sorted (JAX :108): the backbones and zoo
    models; ``bpbreid``, ``pcb`` and ``bot`` build on top of them and are
    not listed, as in JAX."""
    return sorted(BACKBONES)


def register_model(name, fn):
    """Add constructor ``fn`` to the registry under ``name`` (JAX :112);
    it is called as ``fn(num_classes, loss=..., pretrained=...,
    dtype=..., **kwargs)``, as the zoo's constructors are, and can then
    be a BPBReID backbone. A name already taken raises ``KeyError``."""
    if name in BPBREID_FAMILY or name in BACKBONES:
        raise KeyError('model {} already registered'.format(name))
    BACKBONES[name] = fn


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
            "model '{}' is not in the registry (JAX's, "
            "bpbreid_tpu/models/__init__.py; known: {})".format(
                name, ', '.join(PORTED)))
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
