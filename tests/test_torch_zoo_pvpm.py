"""PVPM (``models/pvpm.py``: ``pose_p4``, ``pose_p6``, ``pose_p4s``,
``pose_p6s``) of bpbreid_tpu_torch against the JAX package's, at the
module level (no data manager or engine of either package gives pose
maps; JAX's own ``tests/test_model_zoo.py`` holds it so too).

Seeded JAX variables (BN affines, biases and statistics perturbed) cross
over with ``load_jax_variables``; f32 on the CPU, batch 4 of images of
varied brightness and contrast at 64x32 and seeded pose heatmaps of 56
channels at 16x8 (the pose subnet pools twice, to the trunk's 4x2), JAX
jitted:

- ``pose_p4`` at full depth: eval (the parts' features, L2-normalized
  over the channels and flattened channel-major) to 1e-4 of the largest
  magnitude; train mode (the four part scores and the one-hot pose
  attention, and every running statistic after it) to 1e-3 and 1e-4;
- ``pose_p4s``: eval (features and the regressed part scores) to 1e-4,
  and the four outputs of its train mode;
- ``pose_p6``, ``pose_p6s`` (JAX's tree, key for key, and a finite eval):
  ``tests/test_torch_zoo_pcb.py``.
"""
import jax
import numpy as np
import torch

from bpbreid_tpu import models as jmodels
from bpbreid_tpu_torch.models import BACKBONES
from tests.torch_port_helpers import (assert_close, check_against_jax,
                                      limit_torch_threads, nchw,
                                      seeded_variables, zoo_images,
                                      zoo_init)

limit_torch_threads()

HW = (64, 32)
POSE_CHANNELS = 56
POSE_SHAPE = (HW[0] // 4, HW[1] // 4, POSE_CHANNELS)


def _pose_maps(seed, n):
    return np.random.default_rng(seed).uniform(0.0, 1.0, (n,) + POSE_SHAPE) \
        .astype(np.float32)


def test_pvpm_matches_jax():
    """``pose_p4`` in both modes."""
    jm = jmodels.build_model('pose_p4', 7, pretrained=False)
    tm = BACKBONES['pose_p4'](7)
    x, pose = zoo_images(2, 4, *HW), _pose_maps(3, 4)
    zoo_init(tm, 1)
    variables = seeded_variables(jm, tm, x, pose, initialized=True,
                                 train=True)
    check_against_jax(jm, tm, x, train_tol=1e-3, extra=(pose,),
                      variables=variables)


def test_pvpm_score_regression_matches_jax():
    """``pose_p4s``: the part-score regression (Dense + BN1d + sigmoid on
    the pose subnet's pooled map) beside the features, in eval mode; in
    train mode the scores, the attention, the part scores and the pooled
    part features (``pvpm.py`` :121)."""
    jm = jmodels.build_model('pose_p4s', 7, pretrained=False)
    tm = BACKBONES['pose_p4s'](7)
    x, pose = zoo_images(4, 4, *HW), _pose_maps(5, 4)
    zoo_init(tm, 1)
    variables = seeded_variables(jm, tm, x, pose, initialized=True,
                                 train=True)
    want = jax.jit(lambda v, x, p: jm.apply(v, x, p, train=False))(
        variables, x, pose)
    with torch.no_grad():
        got = tm.eval()(nchw(x), nchw(pose))
        assert_close(got[0], want[0], 1e-4)
        assert_close(got[1], want[1], 1e-4)
        ys, att, scores, parts = tm.train()(nchw(x), nchw(pose))
    assert [tuple(y.shape) for y in ys] == [(4, 7)] * 4
    assert tuple(att.shape) == (4, 4, 4, 2)
    assert tuple(scores.shape) == (4, 4)
    assert [tuple(p.shape) for p in parts] == [(4, 2048)] * 4
    # one part a pixel: the one-hot keeps the argmax part's attention
    assert ((att > 0).sum(dim=1) <= 1).all()
