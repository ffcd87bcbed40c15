"""The numbers that decide ``correct``, each a gap between what the
program produced and what the plain reference computes from the same
inputs and weights."""
import statistics

import torch

__all__ = ['relative_gap', 'leaf_gaps', 'difference_gap', 'crop_gaps',
           'mismatch_share', 'check', 'norms']


def relative_gap(value, ref):
    return abs(value - ref) / max(abs(ref), 1e-30)


def leaf_gaps(prog, ref, keep=None):
    """``{leaf: gap}`` between per-leaf norms ``prog`` and ``ref``
    (``{leaf: float}``): ``|prog - ref|`` over the larger of the leaf's
    reference norm and the median leaf's, over the leaves in ``keep`` (all
    when None)."""
    names = [n for n in ref if keep is None or n in keep]
    med = statistics.median(ref[n] for n in names)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
            for n in names}


def difference_gap(prog, ref):
    """``|prog - ref| / |ref|`` of two tensors, by their L2 norms."""
    return float((prog.float() - ref.float()).norm()
                 / ref.float().norm().clamp(min=1e-30))


def crop_gaps(prog, ref):
    """``[N]`` relative L2 gap of each crop's features (``[N, ...]``)."""
    p = prog.float().reshape(prog.shape[0], -1)
    r = ref.float().reshape(ref.shape[0], -1)
    return (p - r).norm(dim=1) / r.norm(dim=1).clamp(min=1e-30)


def unit(x):
    """``x`` L2-normalized along its last axis."""
    return x / x.norm(dim=-1, keepdim=True).clamp(min=1e-12)


def mismatch_share(prog, ref):
    """Share of the entries of two boolean (or 0/1) tensors that differ."""
    return float((prog.bool() != ref.bool()).float().mean())


def check(value, limit):
    """One compared number as the result line carries it."""
    return {'value': float(value), 'limit': float(limit)}


def norms(tensors):
    """The L2 norm of each tensor, as floats (one read from the device)."""
    if not tensors:
        return []
    return torch.stack([t.float().norm() for t in tensors]).tolist()
