"""Body Part Attention loss: pixel-wise part classification (port of
bpbreid_tpu/losses/bpa.py).

'cl' is label-smoothing CE (the default); 'fl' (focal) and 'dl' (dice)
are the softmax multi-class forms of the JAX version.
"""
import torch
import torch.nn.functional as F

from bpbreid_tpu_torch.constants import PIXELS
from bpbreid_tpu_torch.losses.cross_entropy import cross_entropy_loss

__all__ = ['BodyPartAttentionLoss']


def _focal_loss(logits, targets, gamma=1.0):
    """Multi-class focal loss: -(1-p_t)^gamma log(p_t), mean over pixels."""
    log_p = F.log_softmax(logits, dim=-1)
    onehot = F.one_hot(targets, logits.shape[-1]).to(log_p.dtype)
    log_pt = (onehot * log_p).sum(dim=-1)
    pt = torch.exp(log_pt)
    return (-((1.0 - pt) ** gamma) * log_pt).mean()


def _dice_loss(logits, targets, eps=1e-5):
    """Soft multi-class dice over the pixel axis, mean over (batch, class)."""
    probs = torch.softmax(logits, dim=-1)                 # [N, P, C]
    onehot = F.one_hot(targets, logits.shape[-1]).to(probs.dtype)
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
            loss = cross_entropy_loss(logits.reshape(-1, c), t.reshape(-1),
                                      eps=self.label_smoothing)
        elif self.loss_type == 'fl':
            loss = _focal_loss(logits, t)
        else:
            loss = _dice_loss(logits, t)
        acc = (logits.argmax(dim=-1) == t).float().mean()
        return loss, {PIXELS: {'c': loss, 'a': acc}}
