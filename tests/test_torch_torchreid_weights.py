"""Torchreid checkpoints into the port (``utils/torch_weights.py``) vs the
JAX package's ``load_torch_state_dict`` + ``torch_to_flax``, on the CPU.

The file is built from seeded JAX variables (``flax_to_torch``) as
torchreid writes it: ``module.`` prefixes, a ``num_batches_tracked`` per
BN, a ``'state_dict'`` wrapper and plain ``epoch`` / ``rank1`` /
``config`` entries, for a BPBReID with 11 identity classes on the
depth-reduced HRNet-W32. Both packages load it into a model with 7
classes: the same tensors match, the identity classifiers stay at their
values, and the eval outputs agree to 1e-4 (f32). The HRNet ImageNet
file loads into the backbone as the JAX CLI loads it, tensor for tensor.
"""
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpbreid_tpu.models.bpbreid import BPBreID as JBPBreID
from bpbreid_tpu.scripts import main as jmain
from bpbreid_tpu.utils import torch_weights as jtw
from bpbreid_tpu_torch.data.datasets import clear_dataset_cache
from bpbreid_tpu_torch.models.bpbreid import BPBreID as TBPBreID
from bpbreid_tpu_torch.scripts import main as cli
from bpbreid_tpu_torch.utils.torch_weights import (load_torch_state_dict,
                                                   load_torchreid_state_dict)
from bpbreid_tpu_torch.utils.weights import (jax_variables_to_state_dict,
                                             load_jax_variables)
from tests.torch_port_helpers import (SMALL_W32, limit_torch_threads, nchw,
                                      randomize_variables, to_nhwc, to_np)

limit_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(parts_num=5, backbone='hrnet32', backbone_stages=SMALL_W32,
          dim_reduce_output=32)
CLASSES, FILE_CLASSES = 7, 11
BACKBONE = 'backbone_appearance_feature_extractor.'
EXTRA = {'epoch': 120, 'rank1': np.float64(0.875),
         'config': {'model': {'bpbreid': {'dim_reduce_output': 32}}}}


def torchreid_state_dict(state_dict):
    """``{key: array}`` as a DataParallel model's ``state_dict()``:
    ``module.`` prefixes and a ``num_batches_tracked`` per BN."""
    out = {}
    for k, v in state_dict.items():
        out['module.' + k] = torch.as_tensor(np.ascontiguousarray(v))
        if k.endswith('.running_mean'):
            out['module.' + k[:-len('running_mean')] + 'num_batches_tracked'] \
                = torch.tensor(1000)
    return out


def _jax_torch_key(flax_path):
    """A discarded JAX variable path ('a/b/kernel') as its torch key."""
    path = tuple(flax_path.split('/'))
    coll = 'batch_stats' if path[-1] in ('mean', 'var') else 'params'
    return jtw._torch_key_and_transform(path, coll)[0]


def _other_model_variables(file_vars, seed):
    """Variables of the model that loads the file: every leaf moved off
    the file's value, the identity classifiers with CLASSES outputs."""
    rng = np.random.default_rng(seed)

    def walk(tree, path=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            v = np.asarray(v)
            if 'identity_classifier' in '/'.join(path) \
                    and path[-1] == 'classifier':
                v = v[..., :CLASSES]
            out[k] = (v + 0.05 * rng.standard_normal(v.shape)).astype(
                np.float32)
        return out
    return {coll: walk(tree) for coll, tree in file_vars.items()}


@pytest.fixture(scope='module')
def rig(tmp_path_factory):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 64, 32, 3)).astype(np.float32)
    masks = rng.uniform(size=(2, 16, 8, 6)).astype(np.float32)
    file_vars = randomize_variables(jax.jit(JBPBreID(
        num_classes=FILE_CLASSES, **KW).init)(
            jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(masks)), 1)
    init_vars = _other_model_variables(file_vars, 0)
    path = str(tmp_path_factory.mktemp('weights') / 'model.pth.tar')
    torch.save(dict(EXTRA, state_dict=torchreid_state_dict(
        jtw.flax_to_torch(file_vars))), path)
    return x, masks, file_vars, init_vars, path


def test_torchreid_file_loads_as_in_jax(rig):
    x, masks, file_vars, init_vars, path = rig
    j_sd, j_extra = jtw.load_torch_state_dict(path)
    j_vars, j_matched, j_discarded = jtw.torch_to_flax(j_sd, init_vars)

    sd, extra = load_torch_state_dict(path)
    assert set(sd) == set(j_sd) and extra == j_extra == EXTRA
    model = load_jax_variables(TBPBreID(num_classes=CLASSES, **KW),
                               init_vars)
    matched, discarded = load_torchreid_state_dict(model, sd)
    assert sorted(matched) == sorted(j_matched)
    assert sorted(discarded) == sorted(_jax_torch_key(p)
                                       for p in j_discarded)
    assert discarded and all('identity_classifier' in k for k in discarded)
    assert not any(k.endswith('num_batches_tracked') for k in matched)

    # matched tensors equal the file's, discarded ones keep their values
    init_sd = jax_variables_to_state_dict(init_vars)
    for k, v in model.state_dict().items():
        want = sd[k] if k in matched else torch.from_numpy(init_sd[k])
        assert torch.equal(v, want), k

    want = jax.jit(JBPBreID(num_classes=CLASSES, **KW).apply)(
        j_vars, jnp.asarray(x), jnp.asarray(masks))
    with torch.inference_mode():
        got = model.eval()(nchw(x), nchw(masks))
    for i in (0, 2):                     # embeddings, identity scores
        for k in want[i]:
            np.testing.assert_allclose(to_np(got[i][k]), to_np(want[i][k]),
                                       atol=1e-4, rtol=1e-4, err_msg=k)
    for k in want[1]:
        np.testing.assert_array_equal(to_np(got[1][k]), to_np(want[1][k]))
    np.testing.assert_allclose(to_nhwc(got[3]), to_np(want[3]), atol=1e-4,
                               rtol=1e-4)


def test_strict_load_raises(rig):
    _, _, _, init_vars, path = rig
    sd, _ = load_torch_state_dict(path)
    model = TBPBreID(num_classes=CLASSES, **KW)
    with pytest.raises(ValueError, match='identity_classifier'):
        load_torchreid_state_dict(model, sd, strict=True)
    same = TBPBreID(num_classes=FILE_CLASSES, **KW)
    matched, discarded = load_torchreid_state_dict(same, sd, strict=True)
    assert not discarded and len(matched) == len(same.state_dict())
    sd.pop('backbone_appearance_feature_extractor.conv1.weight')
    with pytest.raises(KeyError, match='conv1.weight'):
        load_torchreid_state_dict(same, sd, strict=True)


def test_hrnet_imagenet_file_loads_as_in_jax(rig, tmp_path):
    """The ImageNet file (raw state dict, backbone keys without prefix,
    an ImageNet classifier head) through the JAX CLI's
    ``maybe_load_hrnet_imagenet`` and the port's."""
    _, _, file_vars, init_vars, _ = rig
    backbone = {k[len(BACKBONE):]: v
                for k, v in jtw.flax_to_torch(file_vars).items()
                if k.startswith(BACKBONE)}
    rng = np.random.default_rng(2)
    backbone['classifier.weight'] = rng.normal(size=(1000, 2048)).astype(
        np.float32)
    backbone['classifier.bias'] = np.zeros(1000, np.float32)
    torch.save({k: torch.from_numpy(v) for k, v in backbone.items()},
               tmp_path / 'hrnetv2_w32_imagenet_pretrained.pth')
    cfg = types.SimpleNamespace(model=types.SimpleNamespace(
        bpbreid=types.SimpleNamespace(hrnet_pretrained_path=str(tmp_path))))

    loaded = []
    jengine = types.SimpleNamespace(
        state=types.SimpleNamespace(params=init_vars['params'],
                                    batch_stats=init_vars['batch_stats']),
        load_variables=loaded.append)
    jmain.maybe_load_hrnet_imagenet(jengine, cfg)
    want = jax_variables_to_state_dict(jax.device_get(loaded[0]))

    model = load_jax_variables(TBPBreID(num_classes=CLASSES, **KW),
                               init_vars)
    matched, discarded = cli.maybe_load_hrnet_imagenet(
        types.SimpleNamespace(model=model), cfg)
    assert sorted(matched) == sorted(BACKBONE + k for k in backbone
                                     if not k.startswith('classifier.'))
    assert not any(k.startswith(BACKBONE) for k in discarded)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        assert torch.equal(v, torch.from_numpy(np.asarray(want[k]))), k


def test_missing_pickled_package_is_named(tmp_path):
    """A checkpoint whose config object needs an absent package (as yacs
    for a reference-written config): the error names it and the file."""
    mod = types.ModuleType('absent_config_pkg')

    class Node(dict):
        pass
    Node.__module__, Node.__qualname__ = 'absent_config_pkg', 'Node'
    mod.Node = Node
    path = tmp_path / 'model.pth'
    sys.modules['absent_config_pkg'] = mod
    try:
        torch.save({'state_dict': {'w': torch.zeros(1)}, 'config': Node(a=1)},
                   path)
    finally:
        del sys.modules['absent_config_pkg']
    with pytest.raises(ModuleNotFoundError, match='absent_config_pkg') as e:
        load_torch_state_dict(str(path))
    assert str(path) in str(e.value)


def test_test_config_runs_the_cli_on_a_torchreid_file(tmp_path):
    """``configs/bpbreid/bpbreid_market1501_test.yaml`` through the port's
    CLI with a torchreid file as ``model.load_weights``, cut to the
    synthetic set, resnet18 and 64x32 on the CPU: ``load_config`` takes
    the file's ``config`` entry (its 64-d reduction), every tensor but the
    identity classifiers (another class count) comes from the file, and
    the test runs."""
    from bpbreid_tpu_torch.config import get_default_config
    from bpbreid_tpu_torch.models import build_model
    cfg = get_default_config()
    cfg.model.bpbreid.backbone = 'resnet18'
    cfg.model.bpbreid.dim_reduce_output = 64
    cfg.model.bpbreid.masks.parts_num = 5          # five_v
    cfg.model.compute_dtype = 'float32'
    src = build_model('bpbreid', 9, config=cfg, device='cpu', seed=5)
    path = str(tmp_path / 'bpbreid_synthetic_resnet18.pth')
    torch.save({'state_dict': torchreid_state_dict(
        {k: v.numpy() for k, v in src.state_dict().items()}),
        'epoch': 3, 'config': {'model': {'bpbreid': {
            'dim_reduce_output': 64, 'hrnet_pretrained_path': 'elsewhere/',
            'masks': {'dir': 'elsewhere', 'preprocess': 'five_v'}}}}}, path)

    clear_dataset_cache()
    engine, (cmc, mAP, _, _) = cli.main([
        '--config-file',
        os.path.join(REPO, 'configs/bpbreid/bpbreid_market1501_test.yaml'),
        '--save_dir', str(tmp_path / 'run'), '--job-id', '1',
        'data.sources', "['synthetic']", 'data.targets', "['synthetic']",
        'data.height', '64', 'data.width', '32', 'test.batch_size', '8',
        'train.batch_size', '8',
        'model.bpbreid.backbone', 'resnet18', 'model.compute_dtype',
        'float32', 'model.load_weights', path, 'use_gpu', 'False'])
    assert engine.config.model.bpbreid.dim_reduce_output == 64
    assert engine.config.model.bpbreid.hrnet_pretrained_path \
        == 'pretrained_models/'
    want, got = src.state_dict(), engine.model.state_dict()
    differ = [k for k, v in got.items() if v.shape != want[k].shape]
    assert differ and all('identity_classifier' in k and 'classifier.' in k
                          for k in differ)
    for k, v in got.items():
        if k not in differ:
            assert torch.equal(v, want[k]), k
    assert 0.0 <= mAP <= 1.0 and len(cmc)
