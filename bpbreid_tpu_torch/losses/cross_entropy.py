"""Label-smoothing cross entropy with optional per-sample weighting
(port of bpbreid_tpu/losses/cross_entropy.py)."""
import torch
import torch.nn.functional as F

__all__ = ['cross_entropy_loss', 'CrossEntropyLoss']


def cross_entropy_loss(inputs, targets, eps=0.1, weights=None,
                       valid_mask=None):
    """CE with label smoothing.

    Args:
        inputs: ``[N, C]`` logits.
        targets: ``[N]`` int labels.
        eps: smoothing weight.
        weights: optional ``[N]`` continuous sample weights, L1-normalized
            over the batch then summed.
        valid_mask: optional ``[N]`` bool; invalid samples are dropped
            from the mean.
    Returns:
        scalar loss, in the dtype of ``inputs``.
    """
    num_classes = inputs.shape[1]
    log_probs = F.log_softmax(inputs, dim=1)
    smooth = (1.0 - eps) * F.one_hot(targets.long(), num_classes).to(
        log_probs.dtype) + eps / num_classes
    per_sample = -(smooth * log_probs).sum(dim=1)               # [N]
    if weights is not None:
        w = weights / weights.abs().sum().clamp(min=1e-12)
        return (per_sample * w).sum()
    if valid_mask is not None:
        m = valid_mask.to(per_sample.dtype)
        return (per_sample * m).sum() / m.sum().clamp(min=1)
    return per_sample.mean()


class CrossEntropyLoss:
    """API mirror of the reference class."""

    def __init__(self, eps=0.1, label_smooth=True):
        self.eps = eps if label_smooth else 0.0

    def __call__(self, inputs, targets, weights=None, valid_mask=None):
        return cross_entropy_loss(inputs, targets, self.eps, weights,
                                  valid_mask)
