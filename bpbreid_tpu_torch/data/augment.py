"""Batched preprocessing and train-time augmentation on the device
(port of bpbreid_tpu/data/augment.py).

Input batches keep the data pipeline's channel-last layout (uint8
images ``[N, H, W, 3]``, float confidence fields ``[N, h, w, C]``);
outputs are channel-first for the model: normalized images
``[N, 3, H, W]`` and grouped masks ``[N, K+1, H/4, W/4]``.

Train time (``train_augment``), as in the JAX version:

  [flip p=.5] -> [pad 10 + random crop] -> [color jitter p=.5]
  -> normalize -> [coarse dropout p=.5], and for the masks the whole
  chain as one bilinear resample at the feature grid
  (``_mask_composed_chain``).

Test time (``eval_preprocess``): normalize, and the same feature-grid
mask chain with no crop, flip or erase; fields larger than the image
grid go through the full-resolution chain instead (``_masks_to_image_grid``
then ``mask_chain``), whose resize filters them.

The random draws are made apart from their use: ``sample_train_draws``
takes them from an explicit ``torch.Generator``, and ``train_augment``
takes them as arguments, so that a test can hand the same draws to this
port and to the JAX helpers (torch cannot reproduce ``jax.random``).
"""
import torch
import torch.nn.functional as F

from bpbreid_tpu_torch.ops.masks import (GroupingSpec, add_background_mask,
                                         group_masks, group_masks_special,
                                         masks_preprocess_all)
from bpbreid_tpu_torch.ops.resize import nearest_indices, resize_nearest
from bpbreid_tpu_torch.ops.tensortools import constant
from bpbreid_tpu_torch.utils.tracing import span

__all__ = ['eval_preprocess', 'mask_chain', 'mask_chain_kwargs',
           'train_augment', 'sample_train_draws', 'slice_draws']

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _masks_to_image_grid(masks, h, w):
    """Bilinear resize of native-resolution confidence fields
    ``[N, C, h0, w0]`` to the image grid, half-pixel centres
    (``jax.image.resize(..., 'linear')``): the first step of the
    full-resolution mask chain, which ``eval_preprocess`` takes for fields
    larger than the image grid in an axis. Upsampling is ``F.interpolate``
    with ``align_corners=False``. Downsampling uses its ``antialias=True``
    triangle filter, the same kind of filter JAX applies there."""
    h0, w0 = masks.shape[-2:]
    return F.interpolate(masks, size=(h, w), mode='bilinear',
                         align_corners=False, antialias=h < h0 or w < w0)


def _normalize(imgs, mean=IMAGENET_MEAN, std=IMAGENET_STD):
    """``[N, H, W, 3]`` float -> normalized, same layout."""
    mean = constant(tuple(mean), imgs.device, dtype=imgs.dtype)
    std = constant(tuple(std), imgs.device, dtype=imgs.dtype)
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


def _hflip(imgs, masks, flip):
    """Flip the samples where ``flip`` ([N] bool) along W (channel-last)."""
    f = flip.view(-1, 1, 1, 1)
    imgs = torch.where(f, imgs.flip(2), imgs)
    if masks is not None:
        masks = torch.where(f, masks.flip(2), masks)
    return imgs, masks


def _pad_crop(imgs, masks, off, pad=10):
    """Zero-pad by ``pad`` and crop back at offsets ``off`` ([N, 2] in
    the padded grid), channel-last."""
    n, h, w, _ = imgs.shape
    rows = (off[:, 0:1] + torch.arange(h, device=off.device))[:, :, None]
    cols = (off[:, 1:2] + torch.arange(w, device=off.device))[:, None, :]
    idx = torch.arange(n, device=off.device)[:, None, None]

    def crop(x):
        return F.pad(x, (0, 0, pad, pad, pad, pad))[idx, rows, cols]

    return crop(imgs), (crop(masks) if masks is not None else None)


def _rgb_to_gray(imgs):
    """ITU-R 601-2 luma."""
    return imgs[..., 0] * 0.299 + imgs[..., 1] * 0.587 + imgs[..., 2] * 0.114


def adjust_saturation(imgs, factor):
    """Blend towards the grayscale image (0 = gray, 1 = identity)."""
    gray = _rgb_to_gray(imgs)[..., None]
    return (factor * imgs + (1.0 - factor) * gray).clamp(0.0, 1.0)


def adjust_hue(imgs, shift):
    """Shift hue by ``shift`` in [-0.5, 0.5] turns (RGB -> HSV, H + shift
    mod 1, -> RGB)."""
    r, g, b = imgs[..., 0], imgs[..., 1], imgs[..., 2]
    maxc = imgs.amax(dim=-1)
    minc = imgs.amin(dim=-1)
    chroma = maxc - minc
    safe = torch.where(chroma == 0, torch.ones_like(chroma), chroma)
    hr = torch.remainder((g - b) / safe, 6.0)
    hg = (b - r) / safe + 2.0
    hb = (r - g) / safe + 4.0
    h = torch.where(maxc == r, hr, torch.where(maxc == g, hg, hb)) / 6.0
    h = torch.where(chroma == 0, torch.zeros_like(h), h)
    h = torch.remainder(h + shift, 1.0)
    k = h[..., None] * 6.0
    i = torch.floor(k)
    f = k - i
    p = minc[..., None]
    v = maxc[..., None]
    q = v - chroma[..., None] * f
    t = p + chroma[..., None] * f
    i = torch.remainder(i.to(torch.int32), 6)

    def select(c0, c1, c2, c3, c4, default):
        out = default
        for j, c in reversed(list(enumerate((c0, c1, c2, c3, c4)))):
            out = torch.where(i == j, c, out)
        return out

    return torch.cat([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                      select(p, p, t, v, v, q)], dim=-1)


def _color_jitter(imgs, apply, brightness=None, contrast=None,
                  saturation=None, hue=None):
    """Brightness -> contrast -> saturation -> hue on [0, 1] images with
    per-sample factors ([N] each, None to skip), kept where ``apply``."""
    out = imgs
    if brightness is not None:
        out = (out * brightness.view(-1, 1, 1, 1)).clamp(0.0, 1.0)
    if contrast is not None:
        c = contrast.view(-1, 1, 1, 1)
        mean = _rgb_to_gray(out).mean(dim=(1, 2)).view(-1, 1, 1, 1)
        out = (out * c + (1 - c) * mean).clamp(0.0, 1.0)
    if saturation is not None:
        out = adjust_saturation(out, saturation.view(-1, 1, 1, 1))
    if hue is not None:
        out = adjust_hue(out, hue.view(-1, 1, 1))
    return torch.where(apply.view(-1, 1, 1, 1), out, imgs)


def _coarse_dropout_params(generator, n, h, w, p=0.5):
    """Random-erase rectangles: ``(apply, y0, x0, hole_h, hole_w)``, each
    [N], in post-crop full-resolution coordinates."""
    dev = generator.device
    apply = torch.rand(n, generator=generator, device=dev) < p
    hole_h = torch.randint(int(h * 0.15), int(h * 0.65) + 1, (n,),
                           generator=generator, device=dev)
    hole_w = torch.randint(int(w * 0.15), int(w * 0.65) + 1, (n,),
                           generator=generator, device=dev)
    y0 = torch.randint(0, h, (n,), generator=generator, device=dev)
    x0 = torch.randint(0, w, (n,), generator=generator, device=dev)
    return (apply, torch.minimum(y0, h - hole_h),
            torch.minimum(x0, w - hole_w), hole_h, hole_w)


def _coarse_dropout(imgs, masks, params, mean=IMAGENET_MEAN):
    """One rectangle per sample: image filled with the (raw) mean values,
    masks zeroed (channel-last)."""
    n, h, w, _ = imgs.shape
    apply, y0, x0, hole_h, hole_w = params
    yy = torch.arange(h, device=imgs.device)[None, :, None]
    xx = torch.arange(w, device=imgs.device)[None, None, :]
    inside = ((yy >= y0[:, None, None]) & (yy < (y0 + hole_h)[:, None, None])
              & (xx >= x0[:, None, None]) & (xx < (x0 + hole_w)[:, None, None])
              & apply[:, None, None])[..., None]
    fill = constant(tuple(mean), imgs.device, dtype=imgs.dtype)
    imgs = torch.where(inside, fill, imgs)
    if masks is not None:
        masks = torch.where(inside, torch.zeros_like(masks), masks)
    return imgs, masks


def _mask_composed_chain(masks, full_h, full_w, off, flip, erase,
                         mask_kwargs, pad=10):
    """The train-time mask pipeline as ONE bilinear resample at the
    feature grid, equal to the full-resolution chain (bilinear upsample
    native -> full, flip, pad + crop, erase-zero, grouping, background,
    nearest /mask_scale downscale): each feature-grid pixel's coordinate
    is walked back (nearest pick -> crop offset -> flip -> half-pixel
    bilinear source position) and the native field sampled there.

    Args:
        masks: ``[N, h0, w0, C]`` native-resolution fields.
        full_h/full_w: the image grid.
        off: ``[N, 2]`` crop offsets into the ``pad``-padded grid, or None.
        flip: ``[N]`` bool, or None.
        erase: ``_coarse_dropout_params`` draws, or None.
    Returns:
        ``[N, K+1, full_h/mask_scale, full_w/mask_scale]`` float masks.
    """
    kw = dict(mask_kwargs or {})
    mask_scale = kw.get('mask_scale', 4)
    out_h, out_w = full_h // mask_scale, full_w // mask_scale
    n, h0, w0, _ = masks.shape
    dev = masks.device
    y_f = nearest_indices(full_h, out_h, dev)
    x_f = nearest_indices(full_w, out_w, dev)

    # crop: position in the unpadded (post-flip) image + validity
    row_valid = col_valid = None
    if off is not None:
        y_p = y_f[None, :] + off[:, 0:1] - pad                 # [n, out_h]
        x_p = x_f[None, :] + off[:, 1:2] - pad                 # [n, out_w]
        row_valid = (y_p >= 0) & (y_p < full_h)
        col_valid = (x_p >= 0) & (x_p < full_w)
        y_p = y_p.clamp(0, full_h - 1)
        x_p = x_p.clamp(0, full_w - 1)
    else:
        y_p = y_f[None, :].expand(n, out_h)
        x_p = x_f[None, :].expand(n, out_w)
    # the flip acts on the unpadded coordinate (it precedes the crop)
    if flip is not None:
        x_p = torch.where(flip.view(n, 1), full_w - 1 - x_p, x_p)

    idx = torch.arange(n, device=dev)
    if (h0, w0) == (full_h, full_w):
        m = masks[idx[:, None, None], y_p[:, :, None], x_p[:, None, :]]
    else:
        # half-pixel bilinear source positions, edge-clamped
        sy = ((y_p.float() + 0.5) * (h0 / full_h) - 0.5).clamp(0.0, h0 - 1.0)
        sx = ((x_p.float() + 0.5) * (w0 / full_w) - 0.5).clamp(0.0, w0 - 1.0)
        y0 = torch.floor(sy).long().clamp(0, max(h0 - 2, 0))
        x0 = torch.floor(sx).long().clamp(0, max(w0 - 2, 0))
        wy = (sy - y0)[:, :, None, None]                       # [n,out_h,1,1]
        r0 = masks[idx[:, None], y0]                           # [n,out_h,w0,C]
        r1 = masks[idx[:, None], (y0 + 1).clamp(max=h0 - 1)]
        rows = r0 * (1.0 - wy) + r1 * wy
        wx = (sx - x0)[:, None, :, None]                       # [n,1,out_w,1]
        ii = idx[:, None, None]
        jj = torch.arange(out_h, device=dev)[None, :, None]
        c0 = rows[ii, jj, x0[:, None, :]]
        c1 = rows[ii, jj, (x0 + 1).clamp(max=w0 - 1)[:, None, :]]
        m = c0 * (1.0 - wx) + c1 * wx                          # [n,oh,ow,C]

    m = _group_only(m.permute(0, 3, 1, 2), **kw)               # [n,K,oh,ow]
    zero = torch.zeros_like(m)
    # zero-fills: outside the crop, and inside the erase rectangle, both
    # before the background step
    if row_valid is not None:
        m = torch.where((row_valid[:, :, None] & col_valid[:, None, :])
                        [:, None], m, zero)
    if erase is not None:
        apply, ey, ex, eh, ew = erase
        row_in = (y_f[None, :] >= ey[:, None]) & (y_f[None, :]
                                                  < (ey + eh)[:, None])
        col_in = (x_f[None, :] >= ex[:, None]) & (x_f[None, :]
                                                  < (ex + ew)[:, None])
        inside = row_in[:, :, None] & col_in[:, None, :] \
            & apply[:, None, None]
        m = torch.where(inside[:, None], zero, m)
    return add_background_mask(m, kw.get('background_strategy', 'threshold'),
                               kw.get('softmax_weight', 15.0),
                               kw.get('mask_filtering_threshold', 0.5))


def _enabled(transforms):
    t = [x.lower() for x in (transforms or [])]
    return {'flip': 'random_flip' in t or 'rf' in t,
            'crop': 'random_crop' in t or 'rc' in t,
            'cj': 'color_jitter' in t or 'cj' in t,
            'erase': 'random_erase' in t or 're' in t}


def sample_train_draws(generator, n, h, w, transforms=('rc', 're'),
                       cj_brightness=0.2, cj_contrast=0.15, cj_saturation=0.0,
                       cj_hue=0.0, cj_p=0.5, pad=10):
    """The random draws of one ``train_augment`` call, from ``generator``
    (on the device where the batch lies).

    Returns a dict: ``flip`` ([N] bool), ``off`` ([N, 2] crop offsets in
    [0, 2*pad]), ``cj`` (dict of per-sample ``apply`` and factors) and
    ``erase`` (``_coarse_dropout_params``); a transform that is off
    draws None.
    """
    on = _enabled(transforms)
    dev = generator.device
    draws = {'flip': None, 'off': None, 'cj': None, 'erase': None}
    if on['flip']:
        draws['flip'] = torch.rand(n, generator=generator, device=dev) < 0.5
    if on['crop']:
        draws['off'] = torch.randint(0, 2 * pad + 1, (n, 2),
                                     generator=generator, device=dev)
    if on['cj']:
        def uniform(lo, hi):
            return lo + (hi - lo) * torch.rand(n, generator=generator,
                                               device=dev)
        cj = {'apply': torch.rand(n, generator=generator, device=dev) < cj_p}
        for name, x in (('brightness', cj_brightness),
                        ('contrast', cj_contrast),
                        ('saturation', cj_saturation)):
            cj[name] = uniform(max(0.0, 1 - x), 1 + x) if x else None
        if cj_hue and not 0.0 <= cj_hue <= 0.5:
            raise ValueError('hue must be in [0, 0.5], got %r' % (cj_hue,))
        cj['hue'] = uniform(-cj_hue, cj_hue) if cj_hue else None
        draws['cj'] = cj
    if on['erase']:
        draws['erase'] = _coarse_dropout_params(generator, n, h, w)
    return draws


def slice_draws(draws, lo, hi):
    """The draws of samples ``lo:hi`` of a batch's ``sample_train_draws``
    (a data-parallel rank's slice of the global batch's draws)."""
    if draws is None:
        return None
    if isinstance(draws, dict):
        return {k: slice_draws(v, lo, hi) for k, v in draws.items()}
    if isinstance(draws, (list, tuple)):
        return type(draws)(slice_draws(v, lo, hi) for v in draws)
    return draws[lo:hi]


def train_augment(imgs_u8, masks, draws, norm_mean=IMAGENET_MEAN,
                  norm_std=IMAGENET_STD, mask_kwargs=None):
    """Train-time pipeline with the given draws (``sample_train_draws``).

    Args:
        imgs_u8: ``[N, H, W, 3]`` uint8.
        masks: ``[N, h, w, C]`` float raw confidence fields, or None.
    Returns:
        (images ``[N, 3, H, W]`` f32 normalized, masks
        ``[N, K+1, H/4, W/4]`` or None)
    """
    imgs = imgs_u8.float() / 255.0
    n, h, w, _ = imgs.shape
    flip, off, cj, erase = (draws.get(k) for k in ('flip', 'off', 'cj',
                                                     'erase'))
    if flip is not None:
        imgs, _ = _hflip(imgs, None, flip)
    if off is not None:
        imgs, _ = _pad_crop(imgs, None, off)
    if cj is not None:
        imgs = _color_jitter(imgs, cj['apply'], cj.get('brightness'),
                             cj.get('contrast'), cj.get('saturation'),
                             cj.get('hue'))
    imgs = _normalize(imgs, norm_mean, norm_std)
    if erase is not None:
        imgs, _ = _coarse_dropout(imgs, None, erase, mean=norm_mean)
    imgs = imgs.permute(0, 3, 1, 2).contiguous()
    if masks is not None:
        masks = _mask_composed_chain(masks.float(), h, w, off, flip, erase,
                                     mask_kwargs)
    return imgs, masks


def eval_preprocess(imgs_u8, masks=None, norm_mean=IMAGENET_MEAN,
                    norm_std=IMAGENET_STD, mask_kwargs=None):
    """Test-time pipeline: normalize + mask chain.

    Fields no larger than the image grid in either axis (the data's 1/8
    grid, or the image's own) take the train path's feature-grid
    resample with no crop, flip or erase (``_mask_composed_chain``,
    span ``augment.eval_masks_grid``): every step of the chain acts per
    pixel, so only the pixels the nearest /mask_scale pick keeps are
    computed. Larger fields keep the full-resolution chain (span
    ``augment.eval_masks_full``): the image-grid resize with its
    antialiasing filter, which no point sample reproduces, then
    ``mask_chain``. Both give the same masks up to the order of the
    bilinear weights' rounding.

    Args:
        imgs_u8: ``[N, H, W, 3]`` uint8.
        masks: ``[N, h, w, C]`` float confidence fields or None.
    Returns:
        (images ``[N, 3, H, W]`` f32, masks ``[N, K+1, H/4, W/4]`` or None)
    """
    imgs = _normalize(imgs_u8.float() / 255.0, norm_mean, norm_std)
    imgs = imgs.permute(0, 3, 1, 2).contiguous()
    if masks is not None:
        h, w = imgs.shape[2:]
        if masks.shape[1] <= h and masks.shape[2] <= w:
            with span('augment.eval_masks_grid'):
                masks = _mask_composed_chain(masks.float(), h, w, None, None,
                                             None, mask_kwargs)
        else:
            with span('augment.eval_masks_full'):
                masks = _masks_to_image_grid(
                    masks.float().permute(0, 3, 1, 2), h, w)
                masks = mask_chain(masks, **(mask_kwargs or {}))
    return imgs, masks


def mask_chain_kwargs(cfg, has_background=False):
    """Mask-chain parameters from the config (JAX
    ``ImageDataManager.mask_chain_kwargs``, datamanager.py:158): the
    grouping of ``masks.preprocess`` for PifPaf-style disk masks; for
    masks that carry their own background channel (``has_background``,
    the dataset's ``masks_dirs`` entry, e.g. Occluded-Duke's
    ``isp_6_parts``) no grouping and the ``'sum'`` background. The chain
    still prepends a background there, as JAX's does, so such a file's
    K + 1 channels leave it as K + 2 (ROADMAP, "The JAX package at
    fault")."""
    mc = cfg.model.bpbreid.masks
    kw = dict(background_strategy=mc.background_computation_strategy,
              softmax_weight=mc.softmax_weight,
              mask_filtering_threshold=mc.mask_filtering_threshold)
    if has_background:
        kw.update(grouping_matrix=None, special=None,
                  background_strategy='sum')
        return kw
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
