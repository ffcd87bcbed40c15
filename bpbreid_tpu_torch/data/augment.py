"""Test-time preprocessing on the device (port of the eval half of
bpbreid_tpu/data/augment.py).

Input batches keep the data pipeline's channel-last layout (uint8
images ``[N, H, W, 3]``, float confidence fields ``[N, h, w, C]``);
outputs are channel-first for the model: normalized images
``[N, 3, H, W]`` and grouped masks ``[N, K+1, H/4, W/4]``.
"""
import torch
import torch.nn.functional as F

from bpbreid_tpu_torch.ops.masks import (GroupingSpec, add_background_mask,
                                         group_masks, group_masks_special,
                                         masks_preprocess_all)
from bpbreid_tpu_torch.ops.resize import resize_nearest

__all__ = ['eval_preprocess', 'mask_chain', 'mask_chain_kwargs']

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _masks_to_image_grid(masks, h, w):
    """Bilinear resize of native-resolution confidence fields
    ``[N, C, h0, w0]`` to the image grid, half-pixel centres
    (``jax.image.resize(..., 'linear')``). Upsampling, the case the data
    gives (fields at 1/8 of the image), is ``F.interpolate`` with
    ``align_corners=False``. Downsampling uses its ``antialias=True``
    triangle filter, the same kind of filter JAX applies there."""
    h0, w0 = masks.shape[-2:]
    if (h0, w0) == (h, w):
        return masks
    return F.interpolate(masks, size=(h, w), mode='bilinear',
                         align_corners=False, antialias=h < h0 or w < w0)


def _normalize(imgs, mean=IMAGENET_MEAN, std=IMAGENET_STD):
    """``[N, H, W, 3]`` float -> normalized, same layout."""
    mean = torch.as_tensor(mean, dtype=imgs.dtype, device=imgs.device)
    std = torch.as_tensor(std, dtype=imgs.dtype, device=imgs.device)
    return (imgs - mean) / std


def _group_only(masks, grouping_matrix=None, combine='max', special=None,
                **_unused):
    """Channel-grouping half of the mask chain (C -> K channels)."""
    if special is not None:
        return group_masks_special(masks, special)
    if grouping_matrix is not None:
        return group_masks(masks, grouping_matrix, combine)
    return masks


def _background_downscale(masks, background_strategy='threshold',
                          softmax_weight=15.0, mask_filtering_threshold=0.5,
                          mask_scale=4, **_unused):
    """Background + nearest /mask_scale downscale half of the chain."""
    masks = add_background_mask(masks, background_strategy, softmax_weight,
                                mask_filtering_threshold)
    h, w = masks.shape[-2:]
    return resize_nearest(masks, h // mask_scale, w // mask_scale)


def mask_chain(masks, **mask_kwargs):
    """Grouping -> background -> nearest /mask_scale downscale on
    ``[N, C, H, W]`` masks."""
    return _background_downscale(_group_only(masks, **mask_kwargs),
                                 **mask_kwargs)


def eval_preprocess(imgs_u8, masks=None, norm_mean=IMAGENET_MEAN,
                    norm_std=IMAGENET_STD, mask_kwargs=None):
    """Test-time pipeline: normalize + mask chain.

    Args:
        imgs_u8: ``[N, H, W, 3]`` uint8.
        masks: ``[N, h, w, C]`` float confidence fields or None.
    Returns:
        (images ``[N, 3, H, W]`` f32, masks ``[N, K+1, H/4, W/4]`` or None)
    """
    imgs = _normalize(imgs_u8.float() / 255.0, norm_mean, norm_std)
    imgs = imgs.permute(0, 3, 1, 2).contiguous()
    if masks is not None:
        masks = masks.float().permute(0, 3, 1, 2)
        masks = _masks_to_image_grid(masks, imgs.shape[2], imgs.shape[3])
        masks = mask_chain(masks, **(mask_kwargs or {}))
    return imgs, masks


def mask_chain_kwargs(cfg):
    """Mask-chain parameters from the config for PifPaf-style disk masks
    (bpbreid_tpu/data/datamanager.py:158; datasets whose masks carry
    their own background channel are not ported yet)."""
    mc = cfg.model.bpbreid.masks
    kw = dict(background_strategy=mc.background_computation_strategy,
              softmax_weight=mc.softmax_weight,
              mask_filtering_threshold=mc.mask_filtering_threshold)
    name = mc.preprocess
    if name == 'none':
        kw.update(grouping_matrix=None, special=None)
    elif name == 'bs_fu_bb':
        kw.update(grouping_matrix=None, special='bs_fu_bb')
    else:
        spec = masks_preprocess_all[name]
        if not isinstance(spec, GroupingSpec):
            raise ValueError('mask preprocess {} is not a grouping '
                             'strategy'.format(name))
        kw.update(grouping_matrix=spec.matrix, combine=spec.combine,
                  special=None)
    return kw
