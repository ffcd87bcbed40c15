"""Body Part Attention loss: pixel-wise part classification (port of
bpbreid_tpu/losses/bpa.py).

'cl' is label-smoothing CE (the default); 'fl' (focal) and 'dl' (dice)
are the softmax multi-class forms of the JAX version.
"""
import torch
import torch.nn.functional as F

from bpbreid_tpu_torch.constants import PIXELS

__all__ = ['BodyPartAttentionLoss']


def _one_hot(targets, num_classes, dtype):
    """``jax.nn.one_hot``: a label outside ``[0, num_classes)`` gives a
    row of zeros (``F.one_hot`` raises). The pixel targets of masks that
    carry their own background channel reach ``num_classes`` (ROADMAP,
    "The JAX package at fault"), and the loss then takes what JAX's
    takes. The identity losses keep ``F.one_hot``'s range check."""
    classes = torch.arange(num_classes, device=targets.device)
    return (targets[..., None] == classes).to(dtype)


def _smoothed_ce(logits, targets, eps=0.1):
    """Label-smoothing CE over the last axis, mean over pixels
    (``losses.cross_entropy.cross_entropy_loss`` on ``_one_hot``)."""
    num_classes = logits.shape[-1]
    log_probs = F.log_softmax(logits, dim=-1)
    smooth = (1.0 - eps) * _one_hot(targets, num_classes, log_probs.dtype) \
        + eps / num_classes
    return -(smooth * log_probs).sum(dim=-1).mean()


def _focal_loss(logits, targets, gamma=1.0):
    """Multi-class focal loss: -(1-p_t)^gamma log(p_t), mean over pixels."""
    log_p = F.log_softmax(logits, dim=-1)
    onehot = _one_hot(targets, logits.shape[-1], log_p.dtype)
    log_pt = (onehot * log_p).sum(dim=-1)
    pt = torch.exp(log_pt)
    return (-((1.0 - pt) ** gamma) * log_pt).mean()


def _dice_loss(logits, targets, eps=1e-5):
    """Soft multi-class dice over the pixel axis, mean over (batch, class)."""
    probs = torch.softmax(logits, dim=-1)                 # [N, P, C]
    onehot = _one_hot(targets, logits.shape[-1], probs.dtype)
    inter = (probs * onehot).sum(dim=1)                   # [N, C]
    denom = probs.sum(dim=1) + onehot.sum(dim=1)
    dice = (2.0 * inter + eps) / (denom + eps)
    return 1.0 - dice.mean()


class BodyPartAttentionLoss:
    def __init__(self, loss_type='cl', label_smoothing=0.1):
        if loss_type not in ('cl', 'fl', 'dl'):
            raise ValueError('Loss {} for part prediction is not supported'
                             .format(loss_type))
        self.loss_type = loss_type
        self.label_smoothing = label_smoothing

    def __call__(self, pixels_cls_scores, targets):
        """
        Args:
            pixels_cls_scores: ``[N, K+1, Hf, Wf]`` logits (channel-first).
            targets: ``[N, Hf, Wf]`` int part labels.
        Returns:
            ``(loss, summary)`` with pixel accuracy under ``summary[PIXELS]``.
        """
        n, c = pixels_cls_scores.shape[:2]
        logits = pixels_cls_scores.reshape(n, c, -1).transpose(1, 2)  # [N,P,C]
        t = targets.reshape(n, -1).long()
        if self.loss_type == 'cl':
            loss = _smoothed_ce(logits, t, eps=self.label_smoothing)
        elif self.loss_type == 'fl':
            loss = _focal_loss(logits, t)
        else:
            loss = _dice_loss(logits, t)
        acc = (logits.argmax(dim=-1) == t).float().mean()
        return loss, {PIXELS: {'c': loss, 'a': acc}}
