"""HACNN (``models/hacnn.py``) and the triplet engine's deep supervision
of bpbreid_tpu_torch against the JAX package's (its spatial transformer:
``tests/test_torch_zoo_ops.py``).

f32 on the CPU, JAX jitted:

- ``hacnn`` at full depth, 160x64, batch 4 of images of varied brightness
  and contrast, seeded variables (BN affines, biases and statistics
  perturbed), the triplet heads: eval (the normalized global and local
  embeddings) to 1e-4; train mode (the two class scores and the two
  embeddings, every running statistic after it) to 1e-3 and 1e-4;
- the triplet and softmax engines on those outputs: JAX's
  ``deep_supervision`` of each loss on JAX's outputs (1e-5); JAX's own
  triplet engine raises on them (pinned).
"""
import types

import numpy as np
import pytest
import torch

from bpbreid_tpu import models as jmodels
from bpbreid_tpu.engine.image.triplet import \
    ImageTripletEngine as JImageTripletEngine
from bpbreid_tpu.losses import CrossEntropyLoss as JCrossEntropyLoss
from bpbreid_tpu.losses import TripletLoss as JTripletLoss
from bpbreid_tpu.losses import deep_supervision as jax_deep_supervision
from bpbreid_tpu_torch.data.augment import IMAGENET_MEAN, IMAGENET_STD
from bpbreid_tpu_torch.engine.image import (ImageSoftmaxEngine,
                                           ImageTripletEngine)
from bpbreid_tpu_torch.models import BACKBONES
from tests.torch_port_helpers import (assert_close, check_against_jax,
                                      limit_torch_threads, zoo_images)

limit_torch_threads()

PIDS = np.array([0, 1, 0, 1])


def test_hacnn_and_its_deep_supervision_match_jax():
    """``hacnn`` (global and ``learn_region`` branches) in both modes, then
    the triplet engine's loss (batch-hard triplet on both embeddings +
    label-smoothed CE on both scores, each averaged over the two heads)
    and the softmax engine's on the port's outputs against JAX's
    ``deep_supervision`` on JAX's (1e-5)."""
    jm = jmodels.build_model('hacnn', 7, loss='triplet', pretrained=False)
    tm = BACKBONES['hacnn'](7, loss='triplet')
    _, got, want = check_against_jax(jm, tm, zoo_images(6, 4, 160, 64),
                                     train_tol=1e-3, outputs=True)
    dm = types.SimpleNamespace(transforms=(), norm_mean=IMAGENET_MEAN,
                               norm_std=IMAGENET_STD)
    pids = torch.as_tensor(PIDS)
    loss, summary = ImageTripletEngine(dm, tm, device='cpu').compute_loss(
        got, pids)
    want_t = jax_deep_supervision(JTripletLoss(margin=0.3), want[1], PIDS)
    want_x = jax_deep_supervision(JCrossEntropyLoss(label_smooth=True),
                                  want[0], PIDS)
    assert_close(summary['triplet']['t'], want_t, 1e-5)
    assert_close(summary['triplet']['x'], want_x, 1e-5)
    assert_close(loss, want_t + want_x, 1e-5)
    loss, _ = ImageSoftmaxEngine(dm, tm, device='cpu').compute_loss(
        got[0], pids)
    assert_close(loss, want_x, 1e-5)


def test_triplet_engine_on_two_heads_fault_in_jax():
    """JAX's ``ImageTripletEngine._compute_loss``
    (``bpbreid_tpu/engine/image/triplet.py`` :31) hands HACNN's pair of
    embeddings to ``TripletLoss``, which multiplies them as one matrix:
    JAX's CLI cannot train ``hacnn`` with ``loss.name triplet``. The
    port's engine averages each loss over the heads, as torchreid's."""
    scores = (np.zeros((4, 7), np.float32),) * 2
    feats = (np.ones((4, 5), np.float32),) * 2
    owner = types.SimpleNamespace(
        weight_t=1.0, weight_x=1.0, criterion_t=JTripletLoss(margin=0.3),
        criterion_x=JCrossEntropyLoss(label_smooth=True))
    with pytest.raises((TypeError, AttributeError)):
        JImageTripletEngine._compute_loss(owner, (scores, feats), PIDS)
    dm = types.SimpleNamespace(transforms=(), norm_mean=IMAGENET_MEAN,
                               norm_std=IMAGENET_STD)
    loss, summary = ImageTripletEngine(
        dm, torch.nn.Identity(), device='cpu').compute_loss(
        (tuple(map(torch.from_numpy, scores)),
         tuple(map(torch.from_numpy, feats))), torch.as_tensor(PIDS))
    assert abs(float(summary['triplet']['x']) - np.log(7)) < 1e-6
    assert abs(float(summary['triplet']['t']) - 0.3) < 1e-6


def test_hacnn_refuses_other_input_sizes():
    """The input is fixed at 160x64, as in JAX."""
    with pytest.raises(ValueError, match='160x64'):
        BACKBONES['hacnn'](7)(torch.zeros(1, 3, 128, 64))
