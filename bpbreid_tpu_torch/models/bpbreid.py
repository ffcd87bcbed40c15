"""BPBReID part-based re-identification model (port of
bpbreid_tpu/models/bpbreid.py).

backbone feature map -> learned pixel-to-part attention -> masked
pooling (GWAP/GAP/GMP) -> per-stream dim-reduce -> BNNeck classifiers.

Channel-first: images ``[N, 3, H, W]``, external masks
``[N, K+1, Hm, Wm]``, pixel logits ``[N, K+1, Hf, Wf]``, part masks
``[N, K, Hf, Wf]``, single masks ``[N, Hf, Wf]``. Embeddings keep the
JAX shapes (``[N, D]``, ``[N, K, D]``) and the output dict keys are the
same (``constants.py``).

Pooling paths, as in the JAX model:
- multires (HRNet default): pool each branch at its native resolution
  with transpose-resized masks; the 1920-channel concat map is never
  built (the ``spatial_features`` output is then ``None``);
- materialized: pool the concat map; with ``use_pallas_pooling`` the
  background-GAP and parts-GWAP go through the fused CUDA kernel
  ``ops/cuda/pooling.py`` (on CPU tensors its plain version).

Train mode (``model.train()``) is ``BPBreID.__call__(..., train=True)``:
batch statistics in every BN (``models/common.py``), the pixel
classifier's virtual multires statistics, the binary training
visibility, and no test-time mask refinement. The fused K2 kernel has no
backward: on the card it refuses inputs that require grad.

Backbones: every feature-map model of the registry
(``models.BACKBONES``: HRNet-W32, the ResNets, the OSNets, the IBN-Net
ResNets, ResNet-mid and the fastreid trunks). The multires path is
HRNet's; another backbone returns one map, which a ``before_pooling``
dim-reduce (1x1 conv + BN + ReLU) shrinks when its width differs from
``dim_reduce_output``; ``before_and_after_pooling`` reduces it to twice
``dim_reduce_output`` under the same condition, then each stream's
pooled embeddings to ``dim_reduce_output``, and on HRNet-W32 only after
pooling, as JAX does.

PCB stripes (``horizontal_stripes``; the ``pcb`` and ``bot``
constructors, and ``masks.type: 'stripes'`` configs): the attention is a
zero background channel plus K horizontal stripes
(``ops/masks.py pcb_stripe_masks``), broadcast over the batch. The model
then has no pixel classifier, pools the materialized map (no multires,
no fused K2 kernel) and returns ``pixels_cls_scores`` None, as the JAX
model does.

``dim_reduce='after_pooling_with_dropout'``: the after-pooling reduction
ends in a dropout of rate 0.5 in train mode, whose keep-mask comes from
the generator that ``set_dropout_generator`` gives it (the engine's),
never from torch's global RNG. JAX draws its bits from ``jax.random``,
which torch cannot reproduce, so the train-mode masks differ by design;
eval mode is the identity in both.
"""
import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from bpbreid_tpu_torch.constants import (
    BACKGROUND, BN_BACKGROUND, BN_CONCAT_PARTS, BN_FOREGROUND, BN_GLOBAL,
    BN_PARTS, CONCAT_PARTS, FOREGROUND, GLOBAL, PARTS)
from bpbreid_tpu_torch.models import BACKBONES
from bpbreid_tpu_torch.models.common import (BN_EPS, BN_MOMENTUM, Dense,
                                             FastBatchNorm, PConv)
from bpbreid_tpu_torch.ops.cuda.pooling import fused_attention_pool
from bpbreid_tpu_torch.ops.masks import pcb_stripe_masks
from bpbreid_tpu_torch.ops.pooling import parts_pooling
from bpbreid_tpu_torch.ops.quant import set_quant_paths
from bpbreid_tpu_torch.ops.resize import (_linear_matrix_align_corners,
                                          linear_matrix_align_corners,
                                          resize_bilinear_align_corners)

__all__ = ['BPBreID', 'BNClassifier', 'PixelToPartClassifier',
           'AfterPoolingDimReduce', 'BeforePoolingDimReduce',
           'GeneratorDropout', 'set_dropout_generator', 'bpbreid', 'pcb',
           'bot']

# the rate of the 'after_pooling_with_dropout' dim-reduce (JAX :327-333)
DIM_REDUCE_DROPOUT = 0.5


class BNClassifier(nn.Module):
    """BNNeck: 1-D batchnorm without bias + bias-free linear."""

    def __init__(self, in_features, num_classes, dtype=torch.float32):
        super().__init__()
        self.bn = FastBatchNorm(in_features, bias=False, channel_dim=-1,
                                dtype=dtype)
        self.classifier = Dense(in_features, num_classes, bias=False,
                                dtype=dtype)

    def forward(self, x):
        feature = self.bn(x)
        return feature, self.classifier(feature)


class PixelToPartClassifier(nn.Module):
    """2-D batchnorm + 1x1 conv -> K+1 per-pixel part logits.

    ``forward(x)``: the materialized path over the ``[N, D, Hf, Wf]``
    concat map, with the JAX op order in the compute dtype.
    ``forward(branches=..., out_hw=...)``: the multires path; BN and the
    1x1 conv are folded per HRNet branch, logits are computed at each
    branch's resolution in f32 and only the (K+1)-channel maps are
    upsampled (align-corners bilinear commutes with the affine head).

    In train mode the BN takes batch statistics, in plain PyTorch ops
    that autograd differentiates (as JAX does): the moments of the
    concat map, or on the multires path the moments of the VIRTUAL
    upsampled concat, per branch: the mean is linear in the branch, and
    E[(A y B^T)^2] per channel is tr(G_h y G_w y^T) / P with the Gram
    matrices G = A^T A of the static interpolation operators. The
    running statistics take the flax update (unclipped variance, as in
    the JAX version).
    """

    def __init__(self, channels, parts_num, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.bn = FastBatchNorm(channels, dtype=dtype)
        # a parameter holder (flax nn.Conv layout in JAX): float always
        self.classifier = PConv(channels, parts_num + 1, 1, bias=True,
                                dtype=dtype, quant=False)

    def _batch_moments(self, x=None, branches=None, out_hw=None):
        """(mean, var) of the map, or of the virtual concat of the
        upsampled branches, per channel in f32 (JAX :131-174)."""
        if branches is None:
            xf = x.float()
            mean = xf.mean(dim=(0, 2, 3))
            return mean, (xf * xf).mean(dim=(0, 2, 3)) - mean * mean
        hf, wf = out_hw
        n, p = branches[0].shape[0], hf * wf
        means, e2s = [], []
        for y in branches:
            h_i, w_i = y.shape[-2:]
            yf = y.float()
            if (h_i, w_i) == (hf, wf):
                # identity resize: the plain moments
                means.append(yf.mean(dim=(0, 2, 3)))
                e2s.append((yf * yf).mean(dim=(0, 2, 3)))
                continue
            a = _linear_matrix_align_corners(h_i, hf)          # [hf, h_i]
            b = _linear_matrix_align_corners(w_i, wf)
            mh, mw, gh, gw = (torch.as_tensor(np.asarray(v), device=y.device)
                              for v in (a.sum(0), b.sum(0), a.T @ a, b.T @ b))
            means.append(torch.einsum('nchw,h,w->c', yf, mh, mw) / (n * p))
            t = torch.einsum('nchw,hk->nckw', yf, gh)
            e2s.append(torch.einsum('nckw,wl,nckl->c', t, gw, yf) / (n * p))
        mean = torch.cat(means)
        return mean, torch.cat(e2s) - mean * mean

    def forward(self, x=None, branches=None, out_hw=None):
        bn, conv = self.bn, self.classifier
        w_mat = conv.weight[:, :, 0, 0]                        # [K+1, D]
        if self.training:
            mean, var = self._batch_moments(x, branches, out_hw)
            with torch.no_grad():
                bn.running_mean.copy_(BN_MOMENTUM * bn.running_mean
                                      + (1.0 - BN_MOMENTUM) * mean)
                bn.running_var.copy_(BN_MOMENTUM * bn.running_var
                                     + (1.0 - BN_MOMENTUM) * var)
        else:
            mean, var = bn.running_mean, bn.running_var
        if branches is None:
            dt = self.dtype
            mul = (torch.rsqrt(var + BN_EPS) * bn.weight).to(dt)
            y = (x.to(dt) - mean.to(dt)[:, None, None]) \
                * mul[:, None, None] + bn.bias.to(dt)[:, None, None]
            # the 1x1 conv as a conv: a contiguous NCHW result, as the
            # fused pooling kernel reads it
            return F.conv2d(y, w_mat.to(dt)[:, :, None, None]) \
                + conv.bias.to(dt)[:, None, None]

        hf, wf = out_hw
        a_full = bn.weight * torch.rsqrt(var + BN_EPS)
        b_full = bn.bias - mean * a_full
        const = w_mat @ b_full + conv.bias                     # [K+1]
        logits, off = None, 0
        for y in branches:
            d = y.shape[1]
            w_i = (a_full[off:off + d, None] * w_mat[:, off:off + d].T)
            # the JAX version contracts in the branch dtype with f32
            # accumulation: round the folded weights to it, sum in f32
            part = torch.einsum('ndhw,dk->nkhw', y.float(),
                                w_i.to(y.dtype).float())
            part = resize_bilinear_align_corners(part, hf, wf)
            logits = part if logits is None else logits + part
            off += d
        return (logits + const[:, None, None]).to(self.dtype)


class GeneratorDropout(nn.Module):
    """Dropout (flax ``nn.Dropout``: kept entries divided by the keep
    probability) whose keep-mask is drawn from ``generator``, on its
    device; the identity in eval mode. In train mode without a
    generator it raises rather than draw from torch's global RNG."""

    def __init__(self, rate):
        super().__init__()
        self.rate = rate
        self.generator = None

    def forward(self, x):
        if not self.training:
            return x
        if self.generator is None:
            raise RuntimeError('GeneratorDropout in train mode needs a '
                               'generator (set_dropout_generator)')
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


def set_dropout_generator(model, generator):
    """Give every ``GeneratorDropout`` of ``model`` its generator."""
    for m in model.modules():
        if isinstance(m, GeneratorDropout):
            m.generator = generator


class AfterPoolingDimReduce(nn.Module):
    """Linear + BN1d + ReLU over the last axis (``[N, D]`` or
    ``[N, K, D]``), then, with ``dropout_rate``, a ``GeneratorDropout``
    at index 3 of ``layers`` (the torch reference's place)."""

    def __init__(self, in_features, output_dim, dropout_rate=None,
                 dtype=torch.float32):
        super().__init__()
        layers = [Dense(in_features, output_dim, bias=True, dtype=dtype),
                  FastBatchNorm(output_dim, channel_dim=-1, dtype=dtype),
                  nn.ReLU()]
        if dropout_rate:
            layers.append(GeneratorDropout(dropout_rate))
        self.layers = nn.ModuleList(layers)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class BeforePoolingDimReduce(nn.Module):
    """1x1 conv (with bias) + BN + ReLU over an ``[N, D, H, W]`` map."""

    def __init__(self, in_channels, output_dim, dtype=torch.float32):
        super().__init__()
        self.layers = nn.ModuleList([
            PConv(in_channels, output_dim, 1, bias=True, dtype=dtype,
                  quant=False),              # flax nn.Conv in JAX
            FastBatchNorm(output_dim, dtype=dtype)])

    def forward(self, x):
        return F.relu(self.layers[1](self.layers[0](x)))


class BPBreID(nn.Module):
    """Part-based re-id network (see module docstring).

    ``forward(images, external_parts_masks=None)`` ->
    ``(embeddings, visibility_scores, id_cls_scores, pixels_cls_scores,
    spatial_features, masks)``.
    """

    def __init__(self, num_classes, parts_num, backbone='hrnet32',
                 pooling='gwap', normalization='identity', last_stride=1,
                 dim_reduce='after_pooling', dim_reduce_output=512,
                 learnable_attention_enabled=True,
                 shared_parts_id_classifier=False,
                 test_use_target_segmentation='none',
                 training_binary_visibility_score=True,
                 testing_binary_visibility_score=True,
                 horizontal_stripes=False, use_pallas_pooling=False,
                 multires_pooling=True, backbone_stages=None,
                 dtype=torch.float32):
        super().__init__()
        if backbone not in BACKBONES:
            raise NotImplementedError(
                "backbone '{}' is not ported yet (ROADMAP Queue 1 item 9; "
                "ported: {})".format(backbone, ', '.join(BACKBONES)))
        if normalization != 'identity':
            raise NotImplementedError(
                "pooling normalization '{}' is not supported (the reference "
                "marks it obsolete; use 'identity')".format(normalization))
        if dim_reduce not in ('none', 'after_pooling', 'before_pooling',
                              'before_and_after_pooling',
                              'after_pooling_with_dropout'):
            raise ValueError("unknown dim_reduce '{}'".format(dim_reduce))
        self.parts_num = parts_num
        self.pooling = pooling
        self.learnable_attention_enabled = learnable_attention_enabled
        self.shared_parts_id_classifier = shared_parts_id_classifier
        self.test_use_target_segmentation = test_use_target_segmentation
        self.training_binary_visibility_score = \
            training_binary_visibility_score
        self.testing_binary_visibility_score = testing_binary_visibility_score
        self.horizontal_stripes = horizontal_stripes
        self.use_pallas_pooling = use_pallas_pooling
        self.dtype = dtype
        self.hrnet = backbone == 'hrnet32'
        self.multires = (self.hrnet and multires_pooling
                         and learnable_attention_enabled
                         and not horizontal_stripes
                         and pooling in ('gwap', 'gap')
                         and dim_reduce != 'before_pooling')

        # through the registry, as in JAX (:304); each constructor ignores
        # the arguments it has no use for
        backbone_kwargs = {} if backbone_stages is None \
            else {'stages': backbone_stages}
        self.backbone_appearance_feature_extractor = BACKBONES[backbone](
            num_classes, loss='part_based', pretrained=False,
            last_stride=last_stride,
            enable_dim_reduction=(dim_reduce == 'before_pooling'),
            dim_reduction_channels=dim_reduce_output, dtype=dtype,
            **backbone_kwargs)
        spatial_dim = self.backbone_appearance_feature_extractor.feature_dim
        # the HRNet reduces inside its head (cls_head) for
        # before_pooling, and not at all before pooling for
        # before_and_after_pooling (JAX :312-315); another backbone's map
        # goes through its own 1x1 conv + BN + ReLU, to twice the output
        # width when the after-pooling reductions follow (JAX :316-318),
        # unless the map already has the output width
        self.use_before_reduce = (
            not self.hrnet
            and dim_reduce in ('before_pooling', 'before_and_after_pooling')
            and spatial_dim != dim_reduce_output)
        if self.use_before_reduce:
            before_out = dim_reduce_output * (
                2 if dim_reduce == 'before_and_after_pooling' else 1)
            self.before_pooling_dim_reduce = BeforePoolingDimReduce(
                spatial_dim, before_out, dtype)
            spatial_dim = before_out
        self.use_after_reduce = dim_reduce in ('after_pooling',
                                               'before_and_after_pooling',
                                               'after_pooling_with_dropout')
        dropout = DIM_REDUCE_DROPOUT \
            if dim_reduce == 'after_pooling_with_dropout' else None
        out_dim = dim_reduce_output if dim_reduce != 'none' else spatial_dim
        if self.use_after_reduce:
            for stream in ('global', 'foreground', 'background', 'parts'):
                setattr(self, '{}_after_pooling_dim_reduce'.format(stream),
                        AfterPoolingDimReduce(spatial_dim, out_dim, dropout,
                                              dtype))
        # stripes replace the attention: JAX creates no pixel classifier
        if not horizontal_stripes:
            self.pixel_classifier = PixelToPartClassifier(spatial_dim,
                                                          parts_num, dtype)
        for name in ('global', 'background', 'foreground'):
            setattr(self, '{}_identity_classifier'.format(name),
                    BNClassifier(out_dim, num_classes, dtype))
        self.concat_parts_identity_classifier = BNClassifier(
            out_dim * parts_num, num_classes, dtype)
        if shared_parts_id_classifier:
            self.parts_identity_classifier = BNClassifier(
                out_dim, num_classes, dtype)
        else:
            self.parts_identity_classifier = nn.ModuleList([
                BNClassifier(out_dim, num_classes, dtype)
                for _ in range(parts_num)])
        set_quant_paths(self)

    def forward(self, images, external_parts_masks=None):
        K = self.parts_num
        train = self.training
        backbone = self.backbone_appearance_feature_extractor
        multires = self.multires and (
            train or self.test_use_target_segmentation == 'none')
        n = images.shape[0]
        if self.hrnet:
            branches = backbone.forward_branches(images)
            hf, wf = branches[0].shape[-2:]
            spatial_features = None if multires else backbone.concat(branches)
        else:
            spatial_features = backbone(images)
            if self.use_before_reduce:
                spatial_features = self.before_pooling_dim_reduce(
                    spatial_features)
            hf, wf = spatial_features.shape[-2:]

        # attention: per-pixel part probabilities [N, K+1, Hf, Wf]
        pixels_cls_scores = None
        if self.horizontal_stripes:
            dt, dev = spatial_features.dtype, spatial_features.device
            probs = torch.cat([torch.zeros((1, hf, wf), dtype=dt, device=dev),
                               pcb_stripe_masks(K, hf, wf, dt, dev)])
            probs = probs[None].expand(n, K + 1, hf, wf)
        elif self.learnable_attention_enabled:
            if multires:
                pixels_cls_scores = self.pixel_classifier(
                    branches=branches, out_hw=(hf, wf))
            else:
                pixels_cls_scores = self.pixel_classifier(spatial_features)
            probs = torch.softmax(pixels_cls_scores, dim=1)
        else:
            if external_parts_masks is None:
                raise ValueError('external masks required when learnable '
                                 'attention is disabled')
            probs = resize_bilinear_align_corners(
                external_parts_masks.to(spatial_features.dtype), hf, wf)

        background_masks = probs[:, 0]                         # [N, Hf, Wf]
        parts_masks = probs[:, 1:]                             # [N, K, Hf, Wf]

        # test-time refinement with external masks
        if not train and self.test_use_target_segmentation != 'none':
            if external_parts_masks is None:
                raise ValueError('external masks required for '
                                 'test_use_target_segmentation')
            ext = resize_bilinear_align_corners(
                external_parts_masks.to(spatial_features.dtype), hf, wf)
            if self.test_use_target_segmentation == 'hard':
                target = ext[:, 1:].amax(dim=1) > ext[:, 0]
                background_masks = (~target).to(parts_masks.dtype)
                parts_masks = torch.where(target[:, None], parts_masks,
                                          torch.tensor(1e-12,
                                                       dtype=parts_masks.dtype,
                                                       device=probs.device))
                # the reference writes the floor into a VIEW of the
                # probabilities, so visibility below sees the floored
                # parts channels with the original background channel
                probs = torch.cat([probs[:, :1], parts_masks], dim=1)
            elif self.test_use_target_segmentation == 'soft':
                # out-of-place in the reference: visibility keeps the
                # unrefined probabilities
                parts_masks = parts_masks * ext[:, 1:]

        foreground_masks = parts_masks.amax(dim=1)             # [N, Hf, Wf]
        global_masks = torch.ones_like(foreground_masks)

        # visibility scores
        if (self.training_binary_visibility_score if train
                else self.testing_binary_visibility_score):
            pred = probs.argmax(dim=1)                          # [N, Hf, Wf]
            vis = F.one_hot(pred, K + 1).flatten(1, 2).amax(dim=1) > 0
            foreground_visibility = vis.any(dim=1)
        else:
            vis = probs.amax(dim=(2, 3))                        # [N, K+1]
            foreground_visibility = vis.amax(dim=1)
        background_visibility = vis[:, 0]
        parts_visibility = vis[:, 1:]
        concat_parts_visibility = foreground_visibility
        global_visibility = torch.ones_like(foreground_visibility)

        # pooling
        if multires:
            (global_embeddings, foreground_embeddings, background_embeddings,
             parts_embeddings) = self._pool_multires(
                branches, foreground_masks, background_masks, parts_masks,
                hf, wf)
        else:
            (global_embeddings, foreground_embeddings, background_embeddings,
             parts_embeddings) = self._pool_materialized(
                spatial_features, foreground_masks, background_masks,
                parts_masks, pixels_cls_scores, hf, wf)

        if self.use_after_reduce:
            global_embeddings = self.global_after_pooling_dim_reduce(
                global_embeddings)
            foreground_embeddings = self.foreground_after_pooling_dim_reduce(
                foreground_embeddings)
            background_embeddings = self.background_after_pooling_dim_reduce(
                background_embeddings)
            parts_embeddings = self.parts_after_pooling_dim_reduce(
                parts_embeddings)

        concat_parts_embeddings = parts_embeddings.reshape(n, -1)

        # BNNeck id classifiers
        bn_global, global_cls = self.global_identity_classifier(
            global_embeddings)
        bn_background, background_cls = self.background_identity_classifier(
            background_embeddings)
        bn_foreground, foreground_cls = self.foreground_identity_classifier(
            foreground_embeddings)
        bn_concat, concat_cls = self.concat_parts_identity_classifier(
            concat_parts_embeddings)
        bn_parts, parts_cls = self._parts_identity_classification(
            parts_embeddings)

        embeddings = {
            GLOBAL: global_embeddings, BACKGROUND: background_embeddings,
            FOREGROUND: foreground_embeddings,
            CONCAT_PARTS: concat_parts_embeddings, PARTS: parts_embeddings,
            BN_GLOBAL: bn_global, BN_BACKGROUND: bn_background,
            BN_FOREGROUND: bn_foreground, BN_CONCAT_PARTS: bn_concat,
            BN_PARTS: bn_parts,
        }
        visibility_scores = {
            GLOBAL: global_visibility, BACKGROUND: background_visibility,
            FOREGROUND: foreground_visibility,
            CONCAT_PARTS: concat_parts_visibility, PARTS: parts_visibility,
        }
        id_cls_scores = {
            GLOBAL: global_cls, BACKGROUND: background_cls,
            FOREGROUND: foreground_cls, CONCAT_PARTS: concat_cls,
            PARTS: parts_cls,
        }
        masks = {
            GLOBAL: global_masks, BACKGROUND: background_masks,
            FOREGROUND: foreground_masks, CONCAT_PARTS: foreground_masks,
            PARTS: parts_masks,
        }
        return (embeddings, visibility_scores, id_cls_scores,
                pixels_cls_scores, spatial_features, masks)

    def _pool_multires(self, branches, foreground_masks, background_masks,
                       parts_masks, hf, wf):
        """Pool every stream per HRNet branch at its native resolution:
        stack the full-resolution masks [ones | fg | bg | parts],
        transpose-resize them to each branch's grid and contract there.
        Equal to pooling the upsampled concat map."""
        dt = branches[0].dtype
        stack = torch.cat([torch.ones_like(foreground_masks)[:, None],
                           foreground_masks[:, None],
                           background_masks[:, None],
                           parts_masks], dim=1).float()        # [N,K+3,Hf,Wf]
        nums = []
        for y in branches:
            h_i, w_i = y.shape[-2:]
            if (h_i, w_i) == (hf, wf):
                adj = stack
            else:
                mh = linear_matrix_align_corners(h_i, hf, y.device)
                mw = linear_matrix_align_corners(w_i, wf, y.device)
                adj = torch.einsum('qh,ncqp,pw->nchw', mh, stack, mw)
            # masks x features in the branch dtype with f32 accumulation
            nums.append(torch.einsum('nchw,ndhw->ncd', adj.to(dt).float(),
                                     y.float()))
        num = torch.cat(nums, dim=-1)                            # [N,K+3,D]
        area = hf * wf
        global_embeddings = (num[:, 0] / area).to(dt)
        foreground_embeddings = (num[:, 1] / area).to(dt)
        background_embeddings = (num[:, 2] / area).to(dt)
        if self.pooling == 'gwap':
            den = parts_masks.float().sum(dim=(2, 3)).clamp(min=1e-6)
            parts_embeddings = (num[:, 3:] / den[..., None]).to(dt)
        else:
            parts_embeddings = (num[:, 3:] / area).to(dt)
        return (global_embeddings, foreground_embeddings,
                background_embeddings, parts_embeddings)

    def _pool_materialized(self, spatial_features, foreground_masks,
                           background_masks, parts_masks, pixels_cls_scores,
                           hf, wf):
        """Pooling over the materialized spatial feature map."""
        global_embeddings = spatial_features.mean(dim=(2, 3))      # [N, D]
        foreground_embeddings = parts_pooling(
            spatial_features, foreground_masks[:, None], 'gap')[:, 0]
        # the fused kernel is only valid when the masks really are
        # softmax(pixel logits): learnable attention (so no stripes, whose
        # pixels_cls_scores is None), no test-time mask refinement
        fused = (self.use_pallas_pooling and self.pooling == 'gwap'
                 and pixels_cls_scores is not None
                 and (self.training
                      or self.test_use_target_segmentation == 'none'))
        if fused:
            num, den, _ = fused_attention_pool(spatial_features,
                                               pixels_cls_scores)
            background_embeddings = (num[:, 0] / (hf * wf)).to(
                spatial_features.dtype)
            parts_embeddings = (
                num[:, 1:] / den[:, 1:].clamp(min=1e-6)[..., None]
            ).to(spatial_features.dtype)                           # [N,K,D]
        else:
            background_embeddings = parts_pooling(
                spatial_features, background_masks[:, None], 'gap')[:, 0]
            parts_embeddings = parts_pooling(
                spatial_features, parts_masks, self.pooling)        # [N,K,D]
        return (global_embeddings, foreground_embeddings,
                background_embeddings, parts_embeddings)

    def _parts_identity_classification(self, parts_embeddings):
        n, k, d = parts_embeddings.shape
        if self.shared_parts_id_classifier:
            bn_flat, cls_flat = self.parts_identity_classifier(
                parts_embeddings.reshape(n * k, d))
            return bn_flat.reshape(n, k, d), cls_flat.reshape(n, k, -1)
        outs = [clf(parts_embeddings[:, i])
                for i, clf in enumerate(self.parts_identity_classifier)]
        return (torch.stack([o[0] for o in outs], dim=1),
                torch.stack([o[1] for o in outs], dim=1))


def bpbreid(num_classes, loss='part_based', pretrained=True, config=None,
            **kwargs):
    """Factory mirroring bpbreid_tpu.models.bpbreid.bpbreid; the
    ``masks.type: 'stripes'`` configs (PCB) give the stripes model."""
    del loss, pretrained
    mc = config.model.bpbreid
    kwargs.setdefault('horizontal_stripes', mc.masks.type == 'stripes')
    dtype = torch.bfloat16 if getattr(config.model, 'compute_dtype',
                                      'float32') == 'bfloat16' \
        else torch.float32
    return BPBreID(
        num_classes=num_classes,
        parts_num=mc.masks.parts_num,
        backbone=mc.backbone,
        pooling=mc.pooling,
        normalization=mc.normalization,
        last_stride=mc.last_stride,
        dim_reduce=mc.dim_reduce,
        dim_reduce_output=mc.dim_reduce_output,
        learnable_attention_enabled=mc.learnable_attention_enabled,
        shared_parts_id_classifier=mc.shared_parts_id_classifier,
        test_use_target_segmentation=mc.test_use_target_segmentation,
        training_binary_visibility_score=mc.training_binary_visibility_score,
        testing_binary_visibility_score=mc.testing_binary_visibility_score,
        use_pallas_pooling=getattr(mc, 'use_pallas_pooling', False),
        multires_pooling=getattr(mc, 'multires_pooling', True),
        dtype=dtype,
        **kwargs)


def pcb(num_classes, loss='part_based', pretrained=True, config=None,
        **kwargs):
    """PCB: stripes, learnable attention off (JAX :632). Sets
    ``config.model.bpbreid.learnable_attention_enabled`` False, as the
    JAX constructor does."""
    config.model.bpbreid.learnable_attention_enabled = False
    return bpbreid(num_classes, loss, pretrained, config,
                   horizontal_stripes=True, **kwargs)


def bot(num_classes, loss='part_based', pretrained=True, config=None,
        **kwargs):
    """BoT: one stripe, learnable attention off (JAX :640); sets both
    in ``config.model.bpbreid``."""
    config.model.bpbreid.masks.parts_num = 1
    config.model.bpbreid.learnable_attention_enabled = False
    return bpbreid(num_classes, loss, pretrained, config,
                   horizontal_stripes=True, **kwargs)
