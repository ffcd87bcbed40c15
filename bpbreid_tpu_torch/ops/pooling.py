"""Masked part pooling heads (port of bpbreid_tpu/ops/pooling.py).

Pool a ``[N, D, H, W]`` feature map into ``[N, K, D]`` part embeddings
under ``[N, K, H, W]`` attention masks. GWAP/GAP are one batched matmul
over the flattened pixel axis with f32 accumulation (inputs are cast to
f32, which is exact for bf16 products, as the JAX version's
``preferred_element_type=f32``); GMP unrolls over the small K axis.
The fused softmax + pooling kernel is ``ops/cuda/pooling.py``.
"""
import torch

__all__ = ['parts_pooling', 'gwap_pool', 'gap_pool', 'gmp_pool']


def _num(features, masks):
    n, d, h, w = features.shape
    k = masks.shape[1]
    f = features.reshape(n, d, h * w).float()
    m = masks.reshape(n, k, h * w)
    return torch.einsum('nkp,ndp->nkd', m.float(), f), m


def gwap_pool(features, masks, eps=1e-6):
    """Global Weighted Average Pooling: sum(mask*feat)/clamp(sum(mask))."""
    num, m = _num(features, masks)
    den = m.sum(dim=-1).clamp(min=eps).float()                # [N, K]
    return (num / den[..., None]).to(features.dtype)


def gap_pool(features, masks):
    """Global Average Pooling of the masked feature map."""
    num, _ = _num(features, masks)
    h, w = features.shape[-2:]
    return (num / (h * w)).to(features.dtype)


def gmp_pool(features, masks):
    """Global Max Pooling of the masked feature map, unrolled over K."""
    outs = [(masks[:, i:i + 1] * features).amax(dim=(2, 3))
            for i in range(masks.shape[1])]
    return torch.stack(outs, dim=1)


def parts_pooling(features, masks, pooling='gwap'):
    """Dispatch on pooling type ('gwap' | 'gap' | 'gmp')."""
    if pooling == 'gwap':
        return gwap_pool(features, masks)
    if pooling == 'gap':
        return gap_pool(features, masks)
    if pooling == 'gmp':
        return gmp_pool(features, masks)
    raise ValueError('pooling type {} not supported'.format(pooling))
