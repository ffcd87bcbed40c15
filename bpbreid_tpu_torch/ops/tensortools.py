"""Masked tensor helpers (port of bpbreid_tpu/ops/tensortools.py)."""
import torch


def replace_values(x, mask, value):
    """Return ``x`` with entries where ``mask`` is True replaced by ``value``."""
    return torch.where(mask, torch.as_tensor(value, dtype=x.dtype,
                                             device=x.device), x)


def masked_mean(x, mask, dim=0):
    """Weighted mean of ``x`` over ``dim`` using ``mask`` as weights.

    Entries whose weights sum to zero are marked with ``-1``, the
    sentinel for "this pair could not be compared". ``mask`` may be
    boolean or continuous in [0, 1].
    """
    mask = mask.to(x.dtype)
    weights = mask.sum(dim=dim)
    safe_weights = weights + (weights == 0).to(x.dtype)
    mean = (x * mask).sum(dim=dim) / safe_weights
    return torch.where(weights == 0, torch.as_tensor(-1.0, dtype=x.dtype,
                                                     device=x.device), mean)
