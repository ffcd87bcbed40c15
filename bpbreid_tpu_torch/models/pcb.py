"""PCB, the Part-based Convolutional Baseline (port of
bpbreid_tpu/models/pcb.py).

A ResNet-50 trunk with the last stride 1 (the port's ``Bottleneck`` and
``ResLayer``), torch's adaptive average pooling into ``parts``
horizontal strips, then in train mode a dropout, a 1x1 conv + BN (+ ReLU)
per strip (``conv5``) and one classifier per strip. Eval returns the
L2-normalized strips flattened channel-major, ``[N, 2048 * parts]``, as
torch flattens ``[N, C, P, 1]``. The dropout's keep-mask comes from the
generator ``set_dropout_generator`` gives it (the engine's), not from
JAX's bits (as the after-pooling dropout of PR 9). Not a part-based
backbone: its eval output is a vector.
"""
import torch
import torch.nn as nn
import torch.nn.functional as F

from bpbreid_tpu_torch.models.common import (Bottleneck, Dense,
                                             FastBatchNorm, GeneratorDropout,
                                             PConv, ResLayer)

__all__ = ['PCBModel', 'pcb_p4', 'pcb_p6', 'adaptive_avg_pool_rows',
           'add_resnet50_trunk', 'run_resnet50_trunk']


def adaptive_avg_pool_rows(x, out_rows):
    """torch ``AdaptiveAvgPool2d((out_rows, 1))`` of an ``[N, C, H, W]``
    map: W averaged fully, H split at torch's floor/ceil boundaries
    (JAX :19). Returns ``[N, C, out_rows]``."""
    h = x.shape[2]
    cols = x.mean(dim=3)                                # [N, C, H]
    outs = []
    for i in range(out_rows):
        lo = (i * h) // out_rows
        hi = -(-((i + 1) * h) // out_rows)              # ceil
        outs.append(cols[:, :, lo:hi].mean(dim=2))
    return torch.stack(outs, dim=2)


def add_resnet50_trunk(module, dtype):
    """Give ``module`` the ResNet-50 trunk with the last stride 1
    (``conv1``, ``bn1``, ``layer1``-``layer4``; PCB and PVPM share it)."""
    # a flax nn.Conv in JAX: float in every int8 mode
    module.conv1 = PConv(3, 64, 7, 2, 3, bias=False, dtype=dtype,
                         quant=False)
    module.bn1 = FastBatchNorm(64, dtype=dtype)
    inplanes = 64
    for i, (planes, blocks, stride) in enumerate(
            ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 1))):
        setattr(module, 'layer{}'.format(i + 1),
                ResLayer(Bottleneck, inplanes, planes, blocks, stride,
                         dtype=dtype))
        inplanes = planes * Bottleneck.expansion


def run_resnet50_trunk(module, x):
    """The ``[N, 2048, H/16, W/16]`` map of ``add_resnet50_trunk``'s
    trunk."""
    x = F.max_pool2d(F.relu(module.bn1(module.conv1(x))), 3, 2, 1)
    for i in range(1, 5):
        x = getattr(module, 'layer{}'.format(i))(x)
    return x


def _l2_normalize(v, dim):
    return v / v.norm(dim=dim, keepdim=True).clamp_min(1e-12)


class _Conv5(nn.Module):
    """The per-strip 1x1 conv + BN (``conv5.layers.0``, ``.1``)."""

    def __init__(self, cin, cout, dtype):
        super().__init__()
        self.layers = nn.ModuleList([
            PConv(cin, cout, 1, bias=False, dtype=dtype, quant=False),
            FastBatchNorm(cout, dtype=dtype)])

    def forward(self, x):
        return self.layers[1](self.layers[0](x))


class PCBModel(nn.Module):
    """(JAX :33) Train mode returns the strips' class scores, a list
    (``'softmax'``), or ``(scores, normalized strips)`` (``'triplet'``)."""

    def __init__(self, num_classes, loss='softmax', parts=6, reduced_dim=256,
                 nonlinear='relu', dtype=torch.float32):
        super().__init__()
        self.loss, self.parts, self.nonlinear = loss, parts, nonlinear
        self.feature_dim = reduced_dim
        add_resnet50_trunk(self, dtype)
        self.dropout = GeneratorDropout(0.5)
        self.conv5 = _Conv5(2048, reduced_dim, dtype)
        self.classifier = nn.ModuleList(
            Dense(reduced_dim, num_classes, dtype=dtype)
            for _ in range(parts))

    def forward(self, x):
        v_g = adaptive_avg_pool_rows(run_resnet50_trunk(self, x),
                                     self.parts)  # [N,C,P]
        if not self.training:
            return _l2_normalize(v_g, 1).reshape(v_g.shape[0], -1)
        v_h = self.conv5(self.dropout(v_g)[..., None])[..., 0]    # [N,D,P]
        if self.nonlinear == 'relu':
            v_h = F.relu(v_h)
        elif self.nonlinear == 'leakyrelu':
            v_h = F.leaky_relu(v_h, 0.1)
        ys = [cls(v_h[:, :, i]) for i, cls in enumerate(self.classifier)]
        if self.loss == 'softmax':
            return ys
        if self.loss == 'triplet':
            return ys, _l2_normalize(v_g, 1).reshape(v_g.shape[0], -1)
        raise KeyError('Unsupported loss: {}'.format(self.loss))


def pcb_p6(num_classes, loss='softmax', pretrained=True, dtype=torch.float32,
           **kwargs):
    return PCBModel(num_classes, loss, parts=6, reduced_dim=256, dtype=dtype)


def pcb_p4(num_classes, loss='softmax', pretrained=True, dtype=torch.float32,
           **kwargs):
    return PCBModel(num_classes, loss, parts=4, reduced_dim=256, dtype=dtype)
