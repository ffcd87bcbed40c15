"""Every shipped config (``configs/bpbreid/*.yaml``) through the port's
CLI config and model factory, on the CPU: ``build_config`` accepts the
file (``model.load_weights ''``: the published checkpoints are not in
the repository) with no option refused, and ``build_model`` builds the
file's model, at a reduced size (the depth-reduced HRNet-W32, a 64x32
input), whose eval forward gives finite embeddings of the configured
streams. The PCB configs give the stripes model."""
import glob
import os
import types

import numpy as np
import pytest
import torch

from bpbreid_tpu_torch.models import build_model
from bpbreid_tpu_torch.scripts.main import build_config
from tests.torch_port_helpers import SMALL_W32, limit_torch_threads

limit_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, 'configs', 'bpbreid',
                                        '*.yaml')))


def test_every_shipped_config_is_listed():
    assert len(CONFIGS) == 13


@pytest.mark.parametrize('path', CONFIGS, ids=os.path.basename)
def test_shipped_config_builds_and_runs(path, tmp_path):
    args = types.SimpleNamespace(save_dir=str(tmp_path), job_id=1,
                                 opts=['model.load_weights', ''])
    cfg = build_config(args, path, makedirs=False)
    mc = cfg.model.bpbreid
    kwargs = {'backbone_stages': SMALL_W32} if mc.backbone == 'hrnet32' \
        else {}
    model = build_model(cfg.model.name, 7, config=cfg, device='cpu',
                        **kwargs)
    stripes = mc.masks.type == 'stripes'
    assert model.horizontal_stripes == stripes
    assert hasattr(model, 'pixel_classifier') != stripes
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 3, 64, 32)).astype(np.float32))
    with torch.inference_mode():
        embeddings, visibility = model(x)[:2]
    for key in mc.test_embeddings:
        assert torch.isfinite(embeddings[key].float()).all(), key
    assert embeddings['parts'].shape[1] == mc.masks.parts_num
