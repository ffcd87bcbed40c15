"""bpbreid_tpu_torch models/common.py blocks and HRNet vs bpbreid_tpu.

Same seeded numpy inputs and the same (perturbed) JAX variables go
through the flax module and its port. Tolerances: f32 1e-4 per block,
1e-3 for the HRNet map (deeper sums in another order); bf16 5e-2
relative (bf16 rounds at every layer, in other places in the two
frameworks)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpbreid_tpu.models import common as jcommon
from bpbreid_tpu.models.hrnet import hrnet32 as j_hrnet32
from bpbreid_tpu_torch.models import common as tcommon
from bpbreid_tpu_torch.models.hrnet import hrnet32 as t_hrnet32
from bpbreid_tpu_torch.utils.weights import load_jax_variables
from tests.torch_port_helpers import (SMALL_W32, nchw, randomize_variables,
                                      to_nhwc)


def _run_pair(jmod, tmod, x, seed, jdtype=jnp.float32,
              tdtype=torch.float32):
    variables = randomize_variables(
        jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x)), seed)
    want = jmod.apply(variables, jnp.asarray(x, jdtype))
    load_jax_variables(tmod, variables)
    with torch.inference_mode():
        got = tmod.eval()(nchw(x).to(tdtype))
    return want, got


def _rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)


@pytest.mark.parametrize('stride,pad,bias', [(1, 1, True), (2, 1, False),
                                             (1, 0, True)])
def test_pconv_matches_jax(stride, pad, bias):
    x = np.random.default_rng(0).normal(size=(2, 9, 7, 8)).astype(np.float32)
    k = 3 if pad else 1
    jm = jcommon.PConv(16, (k, k), strides=(stride, stride),
                       padding=((pad, pad), (pad, pad)), use_bias=bias)
    tm = tcommon.PConv(8, 16, k, stride, pad, bias=bias)
    want, got = _run_pair(jm, tm, x, 0)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), atol=1e-4)


def test_fast_batchnorm_eval_matches_jax():
    x = np.random.default_rng(1).normal(size=(2, 5, 4, 12)).astype(np.float32)
    jm = jcommon.FastBatchNorm(use_running_average=True)
    tm = tcommon.FastBatchNorm(12)
    want, got = _run_pair(jm, tm, x, 1)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), atol=1e-5)
    # bf16 compute dtype: normalize in f32, then one cast
    jm = jcommon.FastBatchNorm(use_running_average=True, dtype=jnp.bfloat16)
    tm = tcommon.FastBatchNorm(12, dtype=torch.bfloat16)
    want, got = _run_pair(jm, tm, x, 1, jnp.bfloat16, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(to_nhwc(got),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize('block,cin,planes,stride,ds', [
    ('BasicBlock', 32, 32, 1, False), ('BasicBlock', 16, 32, 2, True),
    ('Bottleneck', 64, 16, 1, False), ('Bottleneck', 32, 16, 2, True)])
def test_residual_blocks_match_jax(block, cin, planes, stride, ds):
    x = np.random.default_rng(2).normal(size=(2, 8, 6, cin)).astype(np.float32)
    jm = getattr(jcommon, block)(planes, stride, ds)
    tm = getattr(tcommon, block)(cin, planes, stride, ds)
    want, got = _run_pair(jm, tm, x, 2)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), atol=1e-4)


def test_reslayer_matches_jax_f32_and_bf16():
    x = np.random.default_rng(3).normal(size=(2, 8, 4, 64)).astype(np.float32)
    jm = jcommon.ResLayer(jcommon.Bottleneck, 64, 2)
    tm = tcommon.ResLayer(tcommon.Bottleneck, 64, 64, 2)
    assert 'downsample' in dict(tm[0].named_children())
    want, got = _run_pair(jm, tm, x, 3)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), atol=1e-4)
    jm = jcommon.ResLayer(jcommon.Bottleneck, 64, 2, dtype=jnp.bfloat16)
    tm = tcommon.ResLayer(tcommon.Bottleneck, 64, 64, 2, dtype=torch.bfloat16)
    want, got = _run_pair(jm, tm, x, 3, jnp.bfloat16, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert _rel_err(to_nhwc(got), want) < 5e-2


@pytest.fixture(scope='module')
def hrnet_pair():
    x = np.random.default_rng(4).normal(size=(2, 64, 32, 3)).astype(np.float32)
    jm = j_hrnet32(enable_dim_reduction=False, return_branches=True,
                   stages=SMALL_W32)
    variables = randomize_variables(
        jax.jit(jm.init)(jax.random.PRNGKey(4), jnp.asarray(x)), 4)
    tm = t_hrnet32(enable_dim_reduction=False, return_branches=True,
                   stages=SMALL_W32)
    load_jax_variables(tm, variables)
    return x, variables, tm.eval()


def test_hrnet_map_and_branches_match_jax(hrnet_pair):
    x, variables, tm = hrnet_pair
    jm = j_hrnet32(enable_dim_reduction=False, return_branches=True,
                   stages=SMALL_W32)
    want_map, want_branches = jax.jit(jm.apply)(variables, jnp.asarray(x))
    with torch.inference_mode():
        got_map, got_branches = tm(nchw(x))
    assert tuple(got_map.shape) == (2, 1920, 16, 8)
    np.testing.assert_allclose(to_nhwc(got_map), np.asarray(want_map),
                               atol=1e-3)
    assert len(got_branches) == len(want_branches) == 4
    for g, w in zip(got_branches, want_branches):
        np.testing.assert_allclose(to_nhwc(g), np.asarray(w), atol=1e-3)


def test_hrnet_bf16_map_is_f32_and_close_to_jax(hrnet_pair):
    """In bf16 the JAX upsample promotes the concat map to f32; the port
    follows."""
    x, variables, _ = hrnet_pair
    jm = j_hrnet32(enable_dim_reduction=False, stages=SMALL_W32,
                   dtype=jnp.bfloat16)
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    tm = t_hrnet32(enable_dim_reduction=False, stages=SMALL_W32,
                   dtype=torch.bfloat16)
    load_jax_variables(tm, variables)
    with torch.inference_mode():
        got = tm.eval()(nchw(x))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    assert _rel_err(to_nhwc(got), want) < 5e-2


def test_hrnet_state_dict_uses_reference_names(hrnet_pair):
    keys = set(hrnet_pair[2].state_dict())
    for key in ('stage3.0.branches.2.0.conv1.weight',
                'stage3.0.fuse_layers.2.0.1.0.weight',
                'stage3.0.fuse_layers.0.2.1.running_var',
                'transition1.1.0.0.weight', 'transition2.2.0.1.running_mean',
                'incre_modules.3.0.downsample.0.weight', 'layer1.0.bn3.bias'):
        assert key in keys, key
    assert not any(k.endswith('num_batches_tracked') for k in keys)
