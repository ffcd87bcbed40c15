"""Post-training int8 quantization of the inference convolutions (port of
bpbreid_tpu/ops/quant.py).

Two phases, as in JAX:

1. **calibration** -- inside ``int8_calibration(percentile)`` the
   convolutions run in float and each quantization point records the
   running maximum of its per-channel range (``calib_amax``: abs-max, or
   a percentile of ``|x|``) into a float32 buffer of the module that owns
   it, under the name of JAX's ``quant`` collection (``act_amax``,
   ``in_amax``, ``out_amax``, ``branch_amax_<j>``,
   ``<stage>_in_amax_<i>``). The buffers are not persistent (no
   ``state_dict`` entry, as JAX keeps ``quant`` apart from the
   checkpoint's params); ``utils.weights.load_jax_variables`` fills them
   from a JAX ``quant`` collection.
2. **inference** -- inside ``int8_inference(...)`` the activations are
   quantized with the static scale (``quantize_static``: the
   ``quantize_s8`` kernel on the card), the weights per output channel
   after the activation scale is folded in (``_fold_act_scale``,
   ``_quantize_weight_per_channel``), and the convolution runs s8 x s8 ->
   s32 (``quant_conv``: the ``conv_s8`` kernel on the card) with the
   dequantizing epilogue.

The mode matrix (``cfg.test.int8``, ``int8_shared_points``,
``int8_act_granularity``, ``int8_skip_patterns``) is JAX's; see its
module docstring. The switches are ``contextvars``, read at call time
(eager PyTorch has no trace time).

Layout: a ``QTensor``'s ``q`` is the NHWC s8 copy of an NCHW tensor,
with the channels padded to a multiple of 32 (zeros): the layout the
``conv_s8`` kernel reads. ``dequantize`` slices the pad off and returns
an NCHW view of the channels-last result.

Skip patterns are ``'/'``-joined module paths matched as substrings. A
module's path is its ``named_modules()`` name with ``.`` replaced by
``/``, relative to the model that ``set_quant_paths`` was run on (every
BPBReID, HRNet, ResNet and ``ResLayer`` runs it on itself when built), so
``extractor/conv1`` matches ``backbone_appearance_feature_extractor/
conv1``, as in JAX. JAX's flax names join a ModuleList index to its list
(``stage2.0/branches.0/0/conv1``); the port's path is
``stage2/0/branches/0/0/conv1``, so a pattern that spans such a dot
matches in one package only.
"""
import contextlib
import contextvars
from typing import Any, NamedTuple

import numpy as np
import torch

from bpbreid_tpu_torch.ops.cuda.conv_s8 import (conv_s8,
                                                expand_grouped_weight_s8,
                                                pack_weight_s8, quantize_s8)

__all__ = ['int8_inference', 'int8_calibration', 'quant_mode', 'quant_conv',
           'QTensor', 'QuantOpts', 'quantize_static', 'dequantize',
           'calib_amax', 'quant_skipped', 'quant_shared_points',
           'act_scale_from_amax', 'set_quant_paths', 'record_amax',
           'clear_calibration', 'calibrated_scale', 'quantize_calibrated',
           'QuantWeightCache']

DEFAULT_SKIP = ('extractor/conv1', 'extractor/conv2')


class QuantOpts(NamedTuple):
    """The mixed-precision knobs of the int8 graph (``cfg.test.int8_*``;
    defaults mirror config.py, incl. the float stem)."""
    skip_patterns: Any = DEFAULT_SKIP
    shared: bool = True
    act_granularity: str = 'per_tensor'

    @classmethod
    def from_config(cls, tcfg):
        """Build from a ``cfg.test``-style namespace. An explicit empty
        ``int8_skip_patterns`` list means the fully-quantized graph."""
        return cls(
            skip_patterns=tuple(getattr(tcfg, 'int8_skip_patterns',
                                        DEFAULT_SKIP) or ()),
            shared=bool(getattr(tcfg, 'int8_shared_points', True)),
            act_granularity=str(
                getattr(tcfg, 'int8_act_granularity', 'per_tensor')))

    def inference_context(self):
        return int8_inference(skip_patterns=self.skip_patterns,
                              shared=self.shared,
                              act_granularity=self.act_granularity)


_MODE = contextvars.ContextVar('bpbreid_torch_quant_mode', default='off')
_CALIB_PCT = contextvars.ContextVar('bpbreid_torch_quant_calib_pct',
                                    default=100.0)
_SKIP = contextvars.ContextVar('bpbreid_torch_quant_skip',
                               default=DEFAULT_SKIP)
_SHARED = contextvars.ContextVar('bpbreid_torch_quant_shared', default=True)
_ACT_GRAN = contextvars.ContextVar('bpbreid_torch_quant_act_gran',
                                   default='per_tensor')


@contextlib.contextmanager
def _set_mode(mode, percentile=None, skip_patterns=None, shared=None,
              act_granularity=None):
    tokens = [(_MODE, _MODE.set(mode))]
    if percentile is not None:
        tokens.append((_CALIB_PCT, _CALIB_PCT.set(float(percentile))))
    if skip_patterns is not None:
        tokens.append((_SKIP, _SKIP.set(tuple(skip_patterns))))
    if shared is not None:
        tokens.append((_SHARED, _SHARED.set(bool(shared))))
    if act_granularity is not None:
        tokens.append((_ACT_GRAN, _ACT_GRAN.set(act_granularity)))
    try:
        yield
    finally:
        for var, token in reversed(tokens):
            var.reset(token)


def int8_inference(enabled=True, skip_patterns=None, shared=None,
                   act_granularity=None):
    """Convolutions called inside run int8 (see JAX's docstring for the
    three controls; None keeps the current value, by default the float
    stem, shared points and per-tensor scales)."""
    return _set_mode('int8' if enabled else 'off',
                     skip_patterns=skip_patterns, shared=shared,
                     act_granularity=act_granularity)


def int8_calibration(percentile=100.0):
    """Convolutions called inside run in float and record activation
    ranges (running maxima of ``calib_amax``) into their modules'
    buffers."""
    return _set_mode('calibrate', percentile)


def quant_mode():
    return _MODE.get()


def quant_skipped(path):
    """True when the module path (``'/'``-joined, see the module
    docstring) matches one of the active skip patterns: the module then
    stays float."""
    pats = _SKIP.get()
    if not pats:
        return False
    return any(p in path for p in pats)


def quant_shared_points():
    """Whether module-level shared quantization points are active."""
    return _SHARED.get()


def set_quant_paths(root):
    """Give every submodule of ``root`` its path for the skip patterns:
    its ``named_modules()`` name with ``.`` as ``/`` (``root`` itself:
    ``''``)."""
    for name, module in root.named_modules():
        module.quant_path = name.replace('.', '/')
    return root


def act_scale_from_amax(amax):
    """Stored per-channel amax -> activation scale under the active
    granularity: 'per_tensor' collapses it with a max,
    'per_channel_floor<K>' floors each channel at max/K, 'per_channel'
    keeps it. A scalar amax is granularity-agnostic."""
    amax = torch.as_tensor(amax, dtype=torch.float32)
    gran = _ACT_GRAN.get()
    if amax.dim() == 0:
        return amax / 127.0
    if gran == 'per_tensor':
        amax = amax.max()
    elif gran.startswith('per_channel_floor'):
        k = float(gran[len('per_channel_floor'):])
        amax = torch.maximum(amax, amax.max() / k)
    return amax / 127.0


def calib_amax(x):
    """Per-channel calibration range of an NCHW ``x``: abs-max, or the
    configured percentile of ``|x|`` (linear interpolation, as
    ``jnp.quantile``: position ``q * (n - 1)`` in f32) over every axis but
    the channels. The percentile takes the top ``n - floor(pos)`` values
    of each channel (``topk``), not a sort of all of them."""
    pct = _CALIB_PCT.get()
    c = x.shape[1]
    flat = x.float().abs().movedim(1, -1).reshape(-1, c)
    if pct >= 100.0:
        return flat.amax(dim=0)
    n = flat.shape[0]
    pos = np.float32(pct / 100.0) * np.float32(n - 1)
    lo, hi = np.floor(pos), np.ceil(pos)
    w_hi = np.float32(pos - lo)
    w_lo = np.float32(np.float32(1.0) - w_hi)
    lo_i = int(min(max(lo, 0), n - 1))
    hi_i = int(min(max(hi, 0), n - 1))
    # descending: rank r (ascending) is at n - 1 - r
    top = flat.topk(n - lo_i, dim=0).values
    lo_v, hi_v = top[n - 1 - lo_i], top[n - 1 - hi_i]
    return lo_v * float(w_lo) + hi_v * float(w_hi)


@torch.no_grad()
def record_amax(module, name, x):
    """``module.<name> = max(module.<name>, calib_amax(x))``, the buffer
    created as zeros ``[C]`` at its first record."""
    amax = calib_amax(x)
    buf = module._buffers.get(name)
    if buf is None:
        # a normal tensor even inside inference mode, so later
        # calibrations may update it in place
        with torch.inference_mode(False):
            buf = torch.zeros(amax.shape, dtype=torch.float32,
                              device=amax.device)
        module.register_buffer(name, buf, persistent=False)
    torch.maximum(buf, amax, out=buf)


def clear_calibration(root):
    """Drop every recorded activation range under ``root``."""
    for module in root.modules():
        for name in [k for k in module._buffers if _is_amax(k)]:
            del module._buffers[name]
            _invalidate(module)
    return root


def _is_amax(name):
    return name in ('act_amax', 'in_amax', 'out_amax') \
        or name.startswith('branch_amax_') or '_in_amax_' in name


def _invalidate(module):
    cache = getattr(module, 'quant_cache', None)
    if cache is not None:
        cache.clear()
    module.__dict__.pop('_quant_scales', None)


class QTensor(NamedTuple):
    """An int8-quantized activation with its static scale: one s8 copy
    per hot tensor, read by every consumer (convs and residual adds).

    ``q``: s8 ``[N, H, W, Cp]`` (NHWC, channels padded to a multiple of 32
    with zeros); ``scale``: f32 ``()`` or ``[C]``, the dequant multiplier
    (amax / 127, floored at 1e-8); ``channels``: C; ``key``: what the
    scale was made from (the amax buffer, its version and the
    granularity), so a consumer can reuse its quantized weights, or None
    for a scale taken from the data."""
    q: Any
    scale: Any
    channels: int
    key: Any = None

    @property
    def shape(self):
        n, h, w, _ = self.q.shape
        return (n, self.channels, h, w)


def quantize_static(x, act_scale, key=None):
    """NCHW float ``x`` -> QTensor with the given static scale (a scalar,
    or per-channel ``[C]``)."""
    sx = torch.clamp(torch.as_tensor(act_scale, dtype=torch.float32,
                                     device=x.device), min=1e-8)
    return QTensor(quantize_s8(x, sx), sx, x.shape[1], key)


def calibrated_scale(module, name):
    """``(scale, key)`` of ``module``'s buffer ``name`` under the active
    granularity, floored at 1e-8, kept on the module between calls (so a
    calibrated point costs no launch to find its scale)."""
    amax = module._buffers[name]
    key = scale_key(amax)
    scales = module.__dict__.setdefault('_quant_scales', {})
    hit = scales.get(name)
    if hit is None or hit[0] != key:
        hit = (key, torch.clamp(act_scale_from_amax(amax), min=1e-8))
        scales[name] = hit
    return hit[1], key


def quantize_calibrated(module, x, name):
    """``quantize_static(x, act_scale_from_amax(module.<name>))`` with
    the scale ``calibrated_scale`` keeps."""
    sx, key = calibrated_scale(module, name)
    return QTensor(quantize_s8(x, sx), sx, x.shape[1], key)


def dequantize(qt, dtype=torch.bfloat16):
    """QTensor -> NCHW float tensor (a view of the channels-last
    result)."""
    y = (qt.q[..., :qt.channels].float() * qt.scale).to(dtype)
    return y.permute(0, 3, 1, 2)


def _quantize_weight_per_channel(w):
    """OIHW -> s8 with one scale per output channel."""
    scale = torch.clamp(w.abs().amax(dim=(1, 2, 3)), min=1e-6) / 127.0
    q = torch.clamp(torch.round(w / scale.view(-1, 1, 1, 1)), -127, 127) \
        .to(torch.int8)
    return q, scale


def _fold_act_scale(weight, sx, groups):
    """Fold the activation dequant scale into the float OIHW weights:
    output channel ``o`` (group ``o // (Co / groups)``) reads input slice
    ``g * cin_g:(g + 1) * cin_g``."""
    sx = torch.as_tensor(sx, dtype=torch.float32)
    if sx.dim() == 0:
        return weight * sx
    cout, cin_g = weight.shape[:2]
    fold = sx.view(groups, 1, cin_g).expand(groups, cout // groups, cin_g)
    return weight * fold.reshape(cout, cin_g, 1, 1)


def quant_weights(weight, sx, groups, cp):
    """The conv_s8 operands of float OIHW weights for activation scale
    ``sx``: ``(packed s8 [Co, k*k*Kc], sw f32 [Co])``. On the card a
    grouped conv's weights are expanded to the dense block-diagonal
    ``[Co, k*k*Cp]`` that the kernel runs, so a cache keeps that form."""
    wq, sw = _quantize_weight_per_channel(
        _fold_act_scale(weight.float(), sx, groups))
    packed = pack_weight_s8(wq, cp, groups)
    if groups > 1 and packed.is_cuda:
        packed = expand_grouped_weight_s8(packed, weight.shape[-1], cp,
                                          weight.shape[1] * groups, groups)
    return packed, sw.contiguous()


class QuantWeightCache:
    """A module's quantized weights, kept between calls (JAX quantizes
    them once, at trace time): keyed on the weight (object, storage,
    version), the device and the activation scale's key, so a load or a
    device move recomputes them; ``PConv`` also clears it on
    ``load_state_dict``."""

    def __init__(self):
        self._key = self._value = None

    def clear(self):
        self._key = self._value = None

    def get(self, weight, scale_key, make):
        key = (id(weight), weight.data_ptr(), weight._version,
               weight.device, scale_key)
        if scale_key is None or key != self._key:
            value = make()
            if scale_key is None:            # scale from the data
                return value
            self._key, self._value = key, value
        return self._value


def scale_key(amax):
    """The key of a scale made from buffer ``amax`` under the active
    granularity. The buffer itself is part of the key (not its id), so a
    replaced buffer never matches."""
    return (_TensorRef(amax), amax._version, _ACT_GRAN.get())


class _TensorRef:
    """Compares by identity; holds the tensor, so its id is not reused
    while a cache key refers to it."""
    __slots__ = ('t',)

    def __init__(self, t):
        self.t = t

    def __eq__(self, other):
        return isinstance(other, _TensorRef) and other.t is self.t

    def __hash__(self):
        return id(self.t)


def quant_conv(x, weight, stride=1, padding=0, act_scale=None, groups=1,
               out_dtype=torch.bfloat16, bias=None, cache=None, key=None):
    """int8 x int8 -> int32 convolution with a dequantized output.

    Args:
        x: NCHW activations -- a float tensor (quantized here with
            ``act_scale``) or a ``QTensor`` (``act_scale`` ignored; the
            zero point is 0, so the padding is exact in the quantized
            domain).
        weight: float OIHW weights (square kernel).
        act_scale: static activation scale (a scalar or per-channel
            ``[Cin]``), required for a float ``x``; ``key`` its cache key.
        bias: f32 ``[Co]`` added in ``out_dtype`` after the cast, or None.
        cache: a ``QuantWeightCache`` for the quantized weights, or None.
    Returns:
        ``[N, Co, Ho, Wo]`` in ``out_dtype``.
    """
    qt = x if isinstance(x, QTensor) else quantize_static(x, act_scale, key)
    cp = qt.q.shape[-1]

    def make():
        return quant_weights(weight, qt.scale, groups, cp)

    wq, sw = (make() if cache is None
              else cache.get(weight, qt.key, make))
    return conv_s8(qt.q, wq, sw, bias, weight.shape[-1], stride, padding,
                   qt.channels, groups, out_dtype)
