"""Part-based batch-hard triplet losses, fully masked (port of
bpbreid_tpu/losses/triplet.py).

Hard triplets are mined with additive masks and masked means, with
static shapes:

- incomparable pairs carry the ``-1`` sentinel ([K, N, N] entries);
- invalid positives are pushed to ``-1`` before the max, invalid
  negatives to ``+_MAX`` before the min;
- anchors without a valid (positive, negative) pair are left out of the
  mean by a validity mask.

Maxima and minima are ``amax``/``amin``, which share the gradient
between tied entries as ``jnp.max``/``jnp.min`` do.
``PartRandomMaxMinTripletLoss`` draws its dropout from a
``torch.Generator`` in place of a JAX key.
"""
import torch
import torch.nn.functional as F

from bpbreid_tpu_torch.ops.tensortools import masked_mean, replace_values

__all__ = [
    'part_based_pairwise_distance_matrix', 'hard_mine_triplet_loss',
    'PartAveragedTripletLoss', 'PartMaxTripletLoss', 'PartMinTripletLoss',
    'PartMaxMinTripletLoss', 'PartRandomMaxMinTripletLoss',
    'PartIndividualTripletLoss', 'InterPartsTripletLoss', 'TripletLoss',
    'init_part_based_triplet_loss',
]

_MAX = 1e16   # stand-in for finfo.max that stays finite in bf16/f32 math


def part_based_pairwise_distance_matrix(embeddings, squared=False,
                                        epsilon=1e-16):
    """[K, N, D] -> [K, N, N] euclidean distances (f32) via the matmul
    identity; bf16 products are exact in f32, as the JAX version's
    ``preferred_element_type`` gives."""
    e = embeddings.float()
    dot = torch.einsum('knd,kmd->knm', e, e)
    sq = torch.einsum('knd,knd->kn', e, e)
    d2 = F.relu(sq[:, :, None] - 2.0 * dot + sq[:, None, :])
    if squared:
        return d2
    zero = (d2 == 0).to(d2.dtype)
    return torch.sqrt(d2 + zero * epsilon) * (1 - zero)


def _anchor_positive_mask(labels):
    n = labels.shape[0]
    eq = labels[None, :] == labels[:, None]
    return eq & ~torch.eye(n, dtype=torch.bool, device=labels.device)


def _anchor_negative_mask(labels):
    return labels[None, :] != labels[:, None]


def hard_mine_triplet_loss(batch_pairwise_dist, labels, margin=0.3,
                           hard_margin=True):
    """Masked batch-hard triplet loss over [K, N, N] distances.

    ``-1`` entries mark incomparable pairs. Returns
    ``(loss, trivial_triplets_ratio, valid_triplets_ratio)``.
    """
    dist = batch_pairwise_dist
    valid = dist != -1.0
    big = torch.tensor(_MAX, dtype=dist.dtype, device=dist.device)

    pos_mask = _anchor_positive_mask(labels)[None] & valid
    hardest_pos = (dist * pos_mask - (~pos_mask).to(dist.dtype)).amax(dim=-1)
    neg_mask = _anchor_negative_mask(labels)[None] & valid
    hardest_neg = (dist * neg_mask + (~neg_mask).to(dist.dtype) * big) \
        .amin(dim=-1)                                            # [K, N]

    valid_triplets = (hardest_pos != -1.0) & (hardest_neg != big)
    n_valid = valid_triplets.sum().clamp(min=1)

    if hard_margin and margin > 0:
        per_anchor = F.relu(hardest_pos - hardest_neg + margin)
    else:
        # soft margin: log(1 + exp(pos - neg))
        per_anchor = torch.logaddexp(hardest_pos - hardest_neg,
                                     torch.zeros_like(hardest_pos))

    per_anchor = per_anchor * valid_triplets
    loss = per_anchor.sum() / n_valid
    trivial = ((per_anchor == 0.0) & valid_triplets).sum() / n_valid
    valid_ratio = valid_triplets.float().mean()
    return loss, trivial, valid_ratio


def _visibility_pair_mask(parts_visibility):
    """[N, K] visibility -> [K, N, N] pair validity/weights
    (bool -> AND; continuous -> sqrt of product)."""
    v = parts_visibility.T                                  # [K, N]
    if v.dtype == torch.bool:
        return v[:, :, None] & v[:, None, :]
    return torch.sqrt(v[:, :, None] * v[:, None, :])


class PartAveragedTripletLoss:
    """Mean-combined part distances -> single batch-hard loss
    (the GiLt paper's default)."""

    def __init__(self, margin=0.3, epsilon=1e-16, writer=None):
        self.margin = margin
        self.epsilon = epsilon
        self.writer = writer

    def combine(self, part_dist, valid_mask, labels, generator=None):
        if valid_mask is not None:
            return masked_mean(part_dist, valid_mask, dim=0)[None]
        return part_dist.mean(dim=0)[None]

    def __call__(self, part_based_embeddings, labels, parts_visibility=None,
                 generator=None):
        """
        Args:
            part_based_embeddings: ``[N, K, D]``.
            labels: ``[N]`` int person ids.
            parts_visibility: ``[N, K]`` bool or float, optional.
            generator: ``torch.Generator`` of the random variants.
        Returns:
            ``(loss, trivial_triplets_ratio, valid_triplets_ratio)``.
        """
        emb = part_based_embeddings.transpose(0, 1)             # [K, N, D]
        part_dist = part_based_pairwise_distance_matrix(
            emb, epsilon=self.epsilon)
        valid_mask = None
        if parts_visibility is not None:
            valid_mask = _visibility_pair_mask(parts_visibility)
        pairwise = self.combine(part_dist, valid_mask, labels, generator)
        if self.writer is not None:
            self.writer.update_invalid_pairwise_distances_count(pairwise)
        return hard_mine_triplet_loss(pairwise, labels, self.margin,
                                      hard_margin=self.margin > 0)


class PartMaxTripletLoss(PartAveragedTripletLoss):
    def combine(self, part_dist, valid_mask, labels, generator=None):
        if valid_mask is not None:
            part_dist = replace_values(part_dist, valid_mask == 0, -1.0)
        return part_dist.amax(dim=0)[None]


class PartMinTripletLoss(PartAveragedTripletLoss):
    def combine(self, part_dist, valid_mask, labels, generator=None):
        if valid_mask is not None:
            d = replace_values(part_dist, valid_mask == 0, _MAX)
            out = d.amin(dim=0)
            invalid = (valid_mask != 0).sum(dim=0) == 0
            return replace_values(out, invalid, -1.0)[None]
        return part_dist.amin(dim=0)[None]


class PartMaxMinTripletLoss(PartAveragedTripletLoss):
    """max-combine for positive pairs / min-combine for negatives."""

    def combine(self, part_dist, valid_mask, labels, generator=None):
        if valid_mask is not None:
            d_max = replace_values(part_dist, valid_mask == 0, -1.0)
            d_min = replace_values(part_dist, valid_mask == 0, _MAX)
        else:
            d_max = d_min = part_dist
        mx = d_max.amax(dim=0)
        mn = d_min.amin(dim=0)
        eq = labels[None, :] == labels[:, None]
        out = torch.where(eq, mx, mn)
        if valid_mask is not None:
            invalid = (valid_mask != 0).sum(dim=0) == 0
            out = replace_values(out, invalid, -1.0)
        return out[None]


class PartRandomMaxMinTripletLoss(PartMaxMinTripletLoss):
    """Random 50% pair-entry dropout, then max/min combine. The dropout
    is drawn from ``generator`` (a fresh one seeded 0 when None)."""

    def combine(self, part_dist, valid_mask, labels, generator=None):
        if generator is None:
            generator = torch.Generator(part_dist.device).manual_seed(0)
        keep = torch.rand(part_dist.shape, generator=generator,
                          device=part_dist.device) > 0.5
        if valid_mask is None:
            valid_mask = keep
        elif valid_mask.dtype == torch.bool:
            valid_mask = valid_mask & keep
        else:
            valid_mask = valid_mask * keep
        return PartMaxMinTripletLoss.combine(self, part_dist, valid_mask,
                                             labels)


class PartIndividualTripletLoss(PartAveragedTripletLoss):
    """K independent batch-hard losses ('intra_parts')."""

    def combine(self, part_dist, valid_mask, labels, generator=None):
        if valid_mask is not None:
            part_dist = replace_values(part_dist, valid_mask == 0, -1.0)
        return part_dist


class InterPartsTripletLoss:
    """Cross-part embedding space: every (sample, part) is its own
    embedding; positives share id AND part, negatives differ in id."""

    def __init__(self, margin=0.3, epsilon=1e-16, writer=None):
        self.margin = margin
        self.epsilon = epsilon

    def __call__(self, part_based_embeddings, labels, parts_visibility=None,
                 generator=None):
        n, k, d = part_based_embeddings.shape
        # [K*N, D], part-major
        flat = part_based_embeddings.transpose(0, 1).reshape(k * n, d)
        dist = part_based_pairwise_distance_matrix(flat[None],
                                                   epsilon=self.epsilon)[0]
        ids = labels.repeat(k)                          # [K*N]
        parts = torch.arange(k, device=labels.device).repeat_interleave(n)
        same_id = ids[None, :] == ids[:, None]
        same_part = parts[None, :] == parts[:, None]
        pos_mask = same_id & same_part & ~torch.eye(
            k * n, dtype=torch.bool, device=labels.device)
        neg_mask = ~same_id
        big = torch.tensor(_MAX, dtype=dist.dtype, device=dist.device)
        hardest_pos = (dist * pos_mask - (~pos_mask) * 1.0).amax(dim=-1)
        hardest_neg = (dist * neg_mask + (~neg_mask) * big).amin(dim=-1)
        valid = (hardest_pos != -1.0) & (hardest_neg != big)
        per = F.relu(hardest_pos - hardest_neg + self.margin) * valid
        n_valid = valid.sum().clamp(min=1)
        loss = per.sum() / n_valid
        trivial = ((per == 0.0) & valid).sum() / n_valid
        return loss, trivial, valid.float().mean()


class TripletLoss:
    """Classic global batch-hard triplet loss."""

    def __init__(self, margin=0.3):
        self.margin = margin

    def __call__(self, inputs, targets):
        dot = inputs @ inputs.T
        sq = (inputs * inputs).sum(dim=1)
        d2 = sq[:, None] - 2.0 * dot + sq[None, :]
        dist = torch.sqrt(d2.clamp(min=1e-12))
        pos_mask = targets[None, :] == targets[:, None]
        neg_mask = ~pos_mask
        dist_ap = (dist * pos_mask).amax(dim=-1)
        dist_an = (dist * neg_mask + pos_mask * _MAX).amin(dim=-1)
        return F.relu(dist_ap - dist_an + self.margin).mean()


_body_parts_losses = {
    'part_averaged_triplet_loss': PartAveragedTripletLoss,
    'part_max_triplet_loss': PartMaxTripletLoss,
    'part_min_triplet_loss': PartMinTripletLoss,
    'part_max_min_triplet_loss': PartMaxMinTripletLoss,
    'part_random_max_min_triplet_loss': PartRandomMaxMinTripletLoss,
    'inter_parts_triplet_loss': InterPartsTripletLoss,
    'intra_parts_triplet_loss': PartIndividualTripletLoss,
}


def init_part_based_triplet_loss(name, **kwargs):
    """Registry lookup by loss name."""
    if name not in _body_parts_losses:
        raise ValueError('Invalid loss name. Received "{}", but expected one '
                         'of {}'.format(name, sorted(_body_parts_losses)))
    return _body_parts_losses[name](**kwargs)
