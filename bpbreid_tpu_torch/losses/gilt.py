"""GiLt loss: Global-identity / Local-triplet weighting (port of
bpbreid_tpu/losses/gilt.py).

Identity CE on holistic streams, batch-hard triplet on part streams, with
per-stream, per-loss-type weights; visibility-based sample selection is
a masked mean.

Returns ``(loss, summary)`` where ``summary[stream]`` carries scalar
diagnostics ('c' CE loss, 'a' accuracy, 't' triplet loss, 'tt' trivial
ratio, 'vt' valid ratio).
"""
import torch

from bpbreid_tpu_torch.constants import CONCAT_PARTS, FOREGROUND, GLOBAL, PARTS
from bpbreid_tpu_torch.losses.cross_entropy import CrossEntropyLoss
from bpbreid_tpu_torch.losses.triplet import init_part_based_triplet_loss

__all__ = ['GiLtLoss']


def _top1_accuracy(scores, pids, valid_mask=None):
    correct = (scores.argmax(dim=-1) == pids).float()
    if valid_mask is not None:
        m = valid_mask.float()
        return (correct * m).sum() / m.sum().clamp(min=1)
    return correct.mean()


class GiLtLoss:
    default_losses_weights = {
        GLOBAL: {'id': 1., 'tr': 0.},
        FOREGROUND: {'id': 1., 'tr': 0.},
        CONCAT_PARTS: {'id': 1., 'tr': 0.},
        PARTS: {'id': 0., 'tr': 1.},
    }

    def __init__(self, losses_weights=None, use_visibility_scores=False,
                 triplet_margin=0.3, loss_name='part_averaged_triplet_loss',
                 writer=None):
        self.losses_weights = losses_weights or self.default_losses_weights
        self.use_visibility_scores = use_visibility_scores
        self.part_triplet_loss = init_part_based_triplet_loss(
            loss_name, margin=triplet_margin, writer=writer)
        self.identity_loss = CrossEntropyLoss(label_smooth=True)

    def __call__(self, embeddings_dict, visibility_scores_dict,
                 id_cls_scores_dict, pids, generator=None):
        loss_summary = {}
        total = torch.zeros((), dtype=torch.float32, device=pids.device)
        for key in (GLOBAL, FOREGROUND, CONCAT_PARTS, PARTS):
            info = loss_summary.setdefault(key, {})
            ce_w = float(self.losses_weights[key]['id'])
            if ce_w > 0:
                ce, acc = self._id_cls_loss(
                    id_cls_scores_dict[key], visibility_scores_dict[key], pids)
                total = total + ce_w * ce
                info['c'] = ce
                info['a'] = acc
        for key in (GLOBAL, FOREGROUND, CONCAT_PARTS, PARTS):
            info = loss_summary.setdefault(key, {})
            tr_w = float(self.losses_weights[key]['tr'])
            if tr_w > 0:
                tr, trivial, valid = self._triplet_loss(
                    embeddings_dict[key], visibility_scores_dict[key], pids,
                    generator)
                total = total + tr_w * tr
                info['t'] = tr
                info['tt'] = trivial
                info['vt'] = valid
        return total, loss_summary

    def _triplet_loss(self, embeddings, visibility, pids, generator):
        if embeddings.dim() == 2:
            embeddings = embeddings[:, None, :]
        vis = None
        if self.use_visibility_scores:
            vis = visibility if visibility.dim() == 2 else visibility[:, None]
        return self.part_triplet_loss(embeddings, pids, parts_visibility=vis,
                                      generator=generator)

    def _id_cls_loss(self, scores, visibility, pids):
        if scores.dim() == 3:                      # [N, K, C] part scores
            n, k, c = scores.shape
            scores = scores.reshape(n * k, c)
            pids = pids[:, None].expand(n, k).reshape(-1)
            visibility = visibility.reshape(-1)
        weights = valid = None
        if self.use_visibility_scores and visibility.dtype == torch.bool:
            valid = visibility
        elif self.use_visibility_scores:
            weights = visibility
        ce = self.identity_loss(scores, pids, weights=weights,
                                valid_mask=valid)
        return ce, _top1_accuracy(scores, pids, valid)
