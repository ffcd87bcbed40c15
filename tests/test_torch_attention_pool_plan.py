"""The cut of K2's work on the card (``ops/cuda/pooling.py
attention_pool_plan``), on the CPU.

The kernel (``ops/cuda/attention_pool.cu``) runs a cluster of ``s`` CTAs a
sample, each owning a slice of ``slice`` pixels and a range of ``dr``
channels; a CTA tables the probabilities of ``pc`` pixels at a time and
keeps its partial sums ``dc`` channels at a time; the slices' sums meet in
rank order. Checked here: the plan covers every pixel and channel once
with equal slices, none empty, fits a CTA's shared memory and aims at one
CTA an SM; the main path's plan; and the kernel's order of sums, emulated
in torch on the plan's cut (budgets made tight, so that the slices, the
channel ranges, the sub-chunks and the channel chunks all occur), against
the Pallas kernel in interpret mode (JAX) and the port's plain version:
1e-4 absolute, as the plain version is held to JAX
(``tests/test_torch_ops.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpbreid_tpu.ops.pallas.pooling import fused_attention_pool as j_fused
from bpbreid_tpu_torch.ops.cuda import pooling
from bpbreid_tpu_torch.ops.cuda.pooling import (MAX_CLUSTER, STEP,
                                                TARGET_CTAS,
                                                attention_pool_plan,
                                                attention_pool_reference,
                                                attention_pool_smem_bytes)
from tests.torch_port_helpers import limit_torch_threads, nchw

limit_torch_threads()

# (N, D, P, K+1): the models' maps (HRNet-W32 at 384x128, fastreid
# ResNet-IBN-NL, NASNet), the 'eight' masks, chip_smoke's ragged shapes
SHAPES = [(64, 1920, 3072, 6), (64, 2048, 192, 6), (64, 1056, 48, 6),
          (8, 1920, 3072, 9), (2, 40, 7, 3), (3, 100, 3072, 37),
          (2, 1920, 7, 6), (4, 40, 3072, 37), (1, 100, 143, 64),
          (2, 500, 3072, 64), (300, 64, 3072, 6), (132, 500, 64, 64)]
MAX_SMEM = 232448        # bytes a block can use on an H100


@pytest.mark.parametrize('shape', SHAPES)
def test_plan_covers_every_pixel_once_and_fits(shape):
    n, d, p, k1 = shape
    s, slice_, pc, dr, dc = attention_pool_plan(n, d, p, k1)
    assert 1 <= s <= MAX_CLUSTER
    assert slice_ % STEP == 0 and pc % STEP == 0 and 0 < pc <= slice_
    assert (s - 1) * slice_ < p <= s * slice_
    assert -(-p // STEP) % s == 0          # equal slices
    assert dr % 16 == 0 and dc % 16 == 0 and 16 <= dc <= dr
    ranges = -(-d // dr)
    assert (ranges - 1) * dr < d <= ranges * dr
    assert ranges == 1 or s * ranges <= max(1, round(TARGET_CTAS / n))
    assert attention_pool_smem_bytes(k1, pc, dc) <= MAX_SMEM


def test_main_path_plan():
    """HRNet-W32's map at 384x128, batch 64, five_v: a cluster of 2 a
    sample, 1,536 pixels each, one table and one channel range (no
    sub-chunk or channel loop): 128 CTAs, one on each of 128 of the H100's
    132 SMs; the fastreid and NASNet maps, too small to slice, split their
    channels in two instead."""
    assert attention_pool_plan(64, 1920, 96 * 32, 6) == \
        (2, 1536, 1536, 1920, 1920)
    assert attention_pool_smem_bytes(6, 1536, 1920) == 65536 + 82992
    assert attention_pool_plan(64, 2048, 24 * 8, 6) == \
        (1, 192, 192, 1024, 1024)
    assert attention_pool_plan(64, 1056, 12 * 4, 6) == (1, 64, 64, 528, 528)


def _emulate(feats, logits, plan):
    """The kernel's sums on its plan's cut, in its order: per slice the
    sub-chunks' partial sums (by channel chunk) added in turn, then the
    slices' partials added in rank order; den the same, vismax the max."""
    n, d = feats.shape[:2]
    k1 = logits.shape[1]
    f = feats.reshape(n, d, -1).float()
    lg = logits.reshape(n, k1, -1).float()
    p = f.shape[-1]
    s, slice_, pc, dr, dc = plan
    num = torch.zeros(n, k1, d)
    den, vismax = torch.zeros(n, k1), torch.zeros(n, k1)
    for r in range(s):
        s0, s1 = r * slice_, min(p, (r + 1) * slice_)
        assert s0 < s1
        part, pden = torch.zeros(n, k1, d), torch.zeros(n, k1)
        pmax = torch.zeros(n, k1)
        for d_lo in range(0, d, dr):
            d_hi = min(d, d_lo + dr)
            for dc0 in range(d_lo, d_hi, dc):
                dc1 = min(d_hi, dc0 + dc)
                for p0 in range(s0, s1, pc):
                    p1 = min(s1, p0 + pc)
                    probs = torch.softmax(lg[:, :, p0:p1], dim=1)
                    part[:, :, dc0:dc1] += torch.einsum(
                        'nkp,ndp->nkd', probs, f[:, dc0:dc1, p0:p1])
                    if dc0 == 0:       # den and vismax: the first range
                        pden += probs.sum(-1)
                        pmax = torch.maximum(pmax, probs.amax(-1))
        num, den = num + part, den + pden
        vismax = torch.maximum(vismax, pmax)
    return num, den, vismax


@pytest.mark.parametrize('shape, budgets, cuts', [
    ((2, 8, 4, 96, 6), {'TARGET_CTAS': 2}, ''),
    ((2, 8, 4, 96, 6), {}, 'ranges'),
    # three slices of 64 pixels, the last ragged; three channel ranges
    ((2, 9, 15, 40, 6), {}, 'slices ranges'),
    # sub-chunks of 64 pixels in slices of 128, K+1 = 17, channel chunks
    ((1, 24, 16, 24, 17), {'TARGET_CTAS': 3,
                           'PROBS_BYTES': 17 * 4 * 64,
                           'PARTIAL_BYTES': 17 * 4 * 8},
     'slices sub-chunks chunks'),
    ((3, 7, 1, 40, 3), {}, 'ranges')])
def test_kernel_order_of_sums_matches_jax_kernel(shape, budgets, cuts,
                                                 monkeypatch):
    """Small maps with the plan's budgets shrunk (the module's constants)
    so that every cut occurs."""
    n, h, w, d, k1 = shape
    rng = np.random.default_rng(7)
    f = rng.normal(size=(n, h, w, d)).astype(np.float32)
    lg = (3 * rng.normal(size=(n, h, w, k1))).astype(np.float32)
    for name, value in budgets.items():
        monkeypatch.setattr(pooling, name, value)
    plan = attention_pool_plan(n, d, h * w, k1)
    feats, logits = nchw(f), nchw(lg)
    got = _emulate(feats, logits, plan)
    want_k = j_fused(jnp.asarray(f), jnp.asarray(lg), d_tile=d,
                     interpret=True)
    want_p = attention_pool_reference(feats, logits)
    for name, g, wk, wp in zip(('num', 'den', 'vismax'), got, want_k,
                               want_p):
        np.testing.assert_allclose(g.numpy(), np.asarray(wk), atol=1e-4,
                                   err_msg=name)
        np.testing.assert_allclose(g.numpy(), wp.numpy(), atol=1e-4,
                                   err_msg=name)
    s, slice_, pc, dr, dc = plan
    assert ('slices' in cuts) == (s > 1)
    assert ('ranges' in cuts) == (dr < d)
    assert ('sub-chunks' in cuts) == (pc < slice_)
    assert ('chunks' in cuts.replace('sub-chunks', '')) == (dc < dr)
