"""PCB (``models/pcb.py``: ``pcb_p4``, ``pcb_p6``), the softmax engine's
deep supervision and PVPM's ``pose_p6`` and ``pose_p6s`` constructors of
bpbreid_tpu_torch against the JAX package's.

Seeded JAX variables (BN affines, biases and statistics perturbed) cross
over with ``load_jax_variables``; f32 on the CPU, batch 4 of images of
varied brightness and contrast (``zoo_images``), JAX jitted:

- ``pcb_p4`` at full depth: eval outputs to 1e-4 of their largest
  magnitude; train mode (outputs and every running statistic after it)
  to 1e-3 and 1e-4. Its dropout keeps the entries JAX's dropout kept (the
  masks captured from the train-mode apply; the port draws its own from
  the engine's generator otherwise, by design);
- ``pcb_p6``: the same variables as JAX's tree, key for key, and six
  unit strips in eval mode; ``pose_p6`` and ``pose_p6s`` so too;
- the softmax engine on PCB's six (here four) strip scores: the mean of
  the strips' label-smoothed cross entropies, equal to JAX's
  ``deep_supervision`` of JAX's outputs (1e-5); JAX's own engine raises
  on the list (pinned);
- BPBReID refuses the models that return no feature map, and the CLI the
  pose models (no data manager gives pose maps, in JAX either). PVPM's
  tests are in ``tests/test_torch_zoo_pvpm.py``.
"""
import types

import numpy as np
import pytest
import torch

from bpbreid_tpu import models as jmodels
from bpbreid_tpu.engine.image.softmax import \
    ImageSoftmaxEngine as JImageSoftmaxEngine
from bpbreid_tpu.losses import CrossEntropyLoss as JCrossEntropyLoss
from bpbreid_tpu.losses import deep_supervision as jax_deep_supervision
from bpbreid_tpu_torch.data.augment import IMAGENET_MEAN, IMAGENET_STD
from bpbreid_tpu_torch.engine.image import ImageSoftmaxEngine
from bpbreid_tpu_torch.models import BACKBONES, NO_FEATURE_MAP
from bpbreid_tpu_torch.models.bpbreid import BPBreID as TBPBreID
from bpbreid_tpu_torch.models.pcb import adaptive_avg_pool_rows
from tests.torch_port_helpers import (assert_close, check_zoo_constructor,
                                      check_zoo_model,
                                      limit_torch_threads, nchw,
                                      zoo_images)

limit_torch_threads()

# PCB at 96x32: a 6x2 map, so 4 strips take torch's overlapping
# floor/ceil rows (0-1, 1-2, 3-4, 4-5) and 6 strips one row each
PCB_HW = (96, 32)
PIDS = np.array([0, 1, 2, 0])
# PVPM's other constructors at 64x32, with pose maps of 56 channels at
# 16x8 (tests/test_torch_zoo_pvpm.py holds pose_p4 and pose_p4s)
PVPM_HW = (64, 32)
POSE_SHAPE = (16, 8, 56)


def test_adaptive_avg_pool_rows_matches_jax():
    """torch's floor/ceil strip boundaries at odd heights."""
    from bpbreid_tpu.models.pcb import \
        adaptive_avg_pool_rows as jax_pool_rows
    x = zoo_images(0, 2, 7, 3, 5)
    for rows in (1, 3, 4, 6):
        want = np.asarray(jax_pool_rows(x, rows))            # [N, P, C]
        got = adaptive_avg_pool_rows(nchw(x), rows)          # [N, C, P]
        assert_close(got.permute(0, 2, 1), want, 1e-6)


def test_pcb_and_its_deep_supervision_match_jax():
    """``pcb_p4``: eval (the L2-normalized strips, channel-major) and
    train mode (four strip scores; JAX's dropout masks), then the softmax
    engine's loss on the port's strips against JAX's ``deep_supervision``
    on JAX's (1e-5), and its accuracy read from the first strip."""
    tm, got, want = check_zoo_model('pcb_p4', PCB_HW, seed=1, outputs=True)
    assert isinstance(want, list) and len(got) == len(want) == 4
    dm = types.SimpleNamespace(transforms=(), norm_mean=IMAGENET_MEAN,
                               norm_std=IMAGENET_STD)
    engine = ImageSoftmaxEngine(dm, tm, device='cpu')
    pids = torch.as_tensor(PIDS)
    loss, summary = engine.compute_loss(got, pids)
    want_loss = jax_deep_supervision(JCrossEntropyLoss(label_smooth=True),
                                     want, PIDS)
    assert_close(loss, want_loss, 1e-5)
    acc = float((np.asarray(want[0]).argmax(-1) == PIDS).mean())
    assert float(summary['softmax']['acc']) == acc


def test_softmax_engine_on_strip_scores_fault_in_jax():
    """JAX's ``ImageSoftmaxEngine._compute_loss``
    (``bpbreid_tpu/engine/image/softmax.py`` :101) hands PCB's list of
    strip scores to ``cross_entropy_loss``, which reads ``inputs.shape``
    (``losses/cross_entropy.py`` :24): JAX's CLI cannot train ``pcb_p4``
    or ``pcb_p6`` (nor HACNN, whose scores are a pair). The port's engine
    averages the heads' losses, as torchreid's ``DeepSupervision``."""
    scores = [np.zeros((4, 7), np.float32)] * 4
    owner = types.SimpleNamespace(
        criterion=JCrossEntropyLoss(label_smooth=True))
    with pytest.raises(AttributeError, match='shape'):
        JImageSoftmaxEngine._compute_loss(owner, scores, PIDS)
    dm = types.SimpleNamespace(transforms=(), norm_mean=IMAGENET_MEAN,
                               norm_std=IMAGENET_STD)
    engine = ImageSoftmaxEngine(dm, torch.nn.Identity(), device='cpu')
    loss, _ = engine.compute_loss([torch.zeros(4, 7)] * 4,
                                  torch.as_tensor(PIDS))
    assert abs(float(loss) - np.log(7)) < 1e-6


def test_pcb_p6_constructor():
    """``pcb_p6``: JAX's tree, and six normalized strips of 2048."""
    out = check_zoo_constructor(jmodels.build_model('pcb_p6', 7),
                                BACKBONES['pcb_p6'](7), PCB_HW)
    assert tuple(out.shape) == (2, 2048 * 6)
    norms = out.reshape(2, 2048, 6).norm(dim=1)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-5)


def test_models_without_a_feature_map_are_refused():
    """PCB and PVPM return pooled vectors, HACNN embeddings: no BPBReID
    backbone (JAX builds one and fails on the vector's shape); the CLI
    refuses the pose models, whose pose maps no data manager gives."""
    from bpbreid_tpu_torch.scripts.main import build_config
    assert set(NO_FEATURE_MAP) == {'pcb_p4', 'pcb_p6', 'pose_p4', 'pose_p6',
                                   'pose_p4s', 'pose_p6s', 'hacnn'}
    for name in NO_FEATURE_MAP:
        with pytest.raises(ValueError, match='no feature map'):
            TBPBreID(num_classes=7, parts_num=5, backbone=name)
    args = types.SimpleNamespace(
        sources=None, targets=None, transforms=None, root='', save_dir='',
        job_id=None, inference_enabled=False,
        opts=['model.name', 'pose_p4', 'loss.name', 'softmax'])
    with pytest.raises(ValueError, match='pose heatmaps'):
        build_config(args, makedirs=False)


@pytest.mark.parametrize('name', ['pose_p6', 'pose_p6s'])
def test_pvpm_constructors(name):
    """JAX's tree; eval gives six parts of 2048, each a unit vector or,
    where no pixel of the 4x2 map took the part, zeros (and, with the
    part-score regression, the ``[N, 6]`` scores in (0, 1))."""
    out = check_zoo_constructor(jmodels.build_model(name, 7),
                                BACKBONES[name](7), PVPM_HW, POSE_SHAPE)
    flat = out[0] if name.endswith('s') else out
    assert tuple(flat.shape) == (2, 2048 * 6)
    norms = flat.reshape(2, 2048, 6).norm(dim=1)
    assert ((norms - 1).abs().lt(1e-5) | norms.eq(0)).all()
    assert norms.eq(0).sum() < norms.numel()
    if name.endswith('s'):
        assert tuple(out[1].shape) == (2, 6)
        assert ((out[1] > 0) & (out[1] < 1)).all()
