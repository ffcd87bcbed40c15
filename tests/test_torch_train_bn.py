"""The BN kernels' plain versions (K3: ``bn_stats``, ``bn_grad_stats``;
``bn_apply``, ``bn_dx``) and ``FastBatchNorm`` of bpbreid_tpu_torch
against bpbreid_tpu, on the CPU, where the wrappers run their plain
versions.

Tolerances (f32): the sums and statistics at 1e-5 relative (sums over at
most a few hundred values in another order); y, dx, dscale, dbias at
1e-5 absolute plus 1e-5 relative; bf16 outputs at 2e-2 absolute plus
1e-2 relative (one bf16 ulp, rounded at the same places)."""
import importlib.util
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpbreid_tpu.models.common import FastBatchNorm as JFastBatchNorm
from bpbreid_tpu.models.common import _bn_channel_sums, _bn_train
from bpbreid_tpu_torch.models.common import FastBatchNorm
from bpbreid_tpu_torch.ops.cuda.batchnorm import (
    MAX_CLUSTER, bn_apply, bn_apply_reference, bn_dx_reference,
    bn_grad_stats, bn_grad_stats_reference, bn_stats, bn_stats_reference,
    channel_view, elementwise_splits, reduce_splits)
from tests.torch_port_helpers import nchw, to_nhwc, limit_torch_threads

limit_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-5, rtol=1e-5)


def _experiment(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, 'experiments', name + '.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# NHWC shapes: ragged H*W and C, A=1, and a [M, C] feature
SHAPES = [(2, 5, 3, 8), (3, 4, 4, 5), (1, 7, 1, 3), (1, 6, 6, 16), (9, 12)]


def _input(shape, seed):
    rng = np.random.default_rng(seed)
    return (1.5 + 2.0 * rng.standard_normal(shape)).astype(np.float32)


def _port_layout(a):
    """NHWC numpy -> the port's NCHW tensor; [M, C] stays as it is."""
    return nchw(a) if a.ndim == 4 else torch.from_numpy(a)


def _jax_layout(t):
    return to_nhwc(t) if t.dim() == 4 else t.detach().float().numpy()


@pytest.mark.parametrize('shape', SHAPES)
def test_plain_sums_match_jax_channel_sums(shape):
    x = _input(shape, 0)
    want = _bn_channel_sums(jnp.asarray(x), jnp.asarray(x * x), shape[-1])
    got = bn_stats(_port_layout(x), torch.ones(shape[-1]), 1e-5,
                   1 if x.ndim == 4 else -1, sums=True)[4:]
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-4)


def test_plain_sums_match_k3a_and_k3b_references():
    """The two TPU kernels' own plain references (``xla_stats`` of each
    experiment file; K3b's lane-dense fold ``xla_stats_lanes``) give the
    port's sums, bf16 in and f32 out."""
    k3a, k3b = _experiment('pallas_bn_v2'), _experiment('pallas_bn_bench')
    x = jnp.asarray(_input((2, 6, 4, 32), 1)).astype(jnp.bfloat16)
    got = bn_stats(nchw(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16),
                   torch.ones(32), 1e-5, sums=True)[4:]
    for ref in (k3a.xla_stats, k3b.xla_stats, k3b.xla_stats_lanes):
        for g, w in zip(got, ref(x)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-3)


def test_channel_view_and_cluster_plan():
    assert channel_view((64, 256, 96, 32), 1) == (64, 256, 3072)
    assert channel_view((320, 512), -1) == (320, 512, 1)
    assert channel_view((64, 5, 512), -1) == (320, 512, 1)
    # a reduction's cluster holds 1-16 CTAs, never more than the channel
    # (or, for B == 1, the tile) has elements or rows; the elementwise
    # passes stay inside the grid limit
    for a, c, b in ((64, 64, 12288), (64, 256, 3072), (1, 3, 7),
                    (64, 512, 1), (320, 512, 1), (64, 256, 48), (1, 1, 1)):
        s = reduce_splits(a, c, b)
        assert 1 <= s <= min(a * b if b > 1 else a, MAX_CLUSTER)
        assert 1 <= elementwise_splits(a, c, b) <= 65535
    # the step's largest inputs: clusters of 16 and 4 CTAs, 1024 CTAs in
    # all; the small maps and the [M, C] features need few
    assert reduce_splits(64, 64, 12288) == 16
    assert reduce_splits(64, 256, 3072) == 4
    assert reduce_splits(64, 256, 48) == 1
    assert reduce_splits(320, 512, 1) == 5
    assert elementwise_splits(64, 64, 12288) == 16


@pytest.mark.parametrize('shape', SHAPES)
def test_train_bn_matches_jax_vjp(shape):
    x = _input(shape, 2)
    c = shape[-1]
    rng = np.random.default_rng(3)
    scale = (1 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.3 * rng.standard_normal(c)).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    eps = 1e-5

    (y, mean, var), vjp = jax.vjp(lambda a, s, b: _bn_train(a, s, b, eps),
                                  jnp.asarray(x), jnp.asarray(scale),
                                  jnp.asarray(bias))
    dx, dscale, dbias = vjp((jnp.asarray(dy), jnp.zeros(c), jnp.zeros(c)))

    bn = FastBatchNorm(c, channel_dim=1 if x.ndim == 4 else -1).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    tx = _port_layout(x).requires_grad_(True)
    ty = bn(tx)
    ty.backward(_port_layout(dy))

    np.testing.assert_allclose(_jax_layout(ty), np.asarray(y), **TOL)
    np.testing.assert_allclose(_jax_layout(tx.grad), np.asarray(dx), **TOL)
    np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(dscale),
                               **TOL)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(dbias), **TOL)
    # the running update takes the batch mean and the biased variance
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               0.1 * np.asarray(mean), **TOL)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               0.9 + 0.1 * np.asarray(var), **TOL)


@pytest.mark.parametrize('kind,shape', [('fast', (2, 5, 3, 8)),
                                        ('flax', (6, 16)),
                                        ('flax', (4, 5, 16)),
                                        ('flax_nobias', (6, 16))])
def test_running_update_matches_flax(kind, shape):
    """Two train steps of the port against flax ``FastBatchNorm``
    (HRNet) and ``nn.BatchNorm`` (BNNeck, dim-reduce; ``[N, D]`` and
    ``[N, K, D]``) under ``mutable=['batch_stats']``: outputs and the
    running statistics."""
    c = shape[-1]
    if kind == 'fast':
        jm = JFastBatchNorm(use_running_average=False)
    else:
        jm = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                           epsilon=1e-5, use_bias=kind == 'flax')
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0),
                                       jnp.zeros(shape)))
    rng = np.random.default_rng(4)
    variables['batch_stats'] = {
        'mean': (0.1 * rng.standard_normal(c)).astype(np.float32),
        'var': rng.uniform(0.5, 1.5, c).astype(np.float32)}
    variables['params']['scale'] = (1 + 0.1 * rng.standard_normal(c)) \
        .astype(np.float32)
    bn = FastBatchNorm(c, bias=kind != 'flax_nobias',
                       channel_dim=1 if len(shape) == 4 else -1).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(variables['params']['scale']))
        if bn.bias is not None:
            bn.bias.copy_(torch.from_numpy(
                np.asarray(variables['params']['bias'])))
        bn.running_mean.copy_(torch.from_numpy(
            variables['batch_stats']['mean']))
        bn.running_var.copy_(torch.from_numpy(
            variables['batch_stats']['var']))
    for step in range(2):
        x = _input(shape, 10 + step)
        y, mutated = jm.apply(variables, jnp.asarray(x),
                              mutable=['batch_stats'])
        variables = {**variables, **jax.device_get(mutated)}
        with torch.no_grad():
            ty = bn(_port_layout(x))
        np.testing.assert_allclose(_jax_layout(ty), np.asarray(y), **TOL)
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   variables['batch_stats']['mean'], **TOL)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   variables['batch_stats']['var'], **TOL)


def test_train_bn_bf16_matches_jax():
    """bf16 in and out: y and dx round to bf16 at the same places (one
    bf16 ulp apart at most)."""
    shape = (2, 6, 4, 8)
    x = jnp.asarray(_input(shape, 5)).astype(jnp.bfloat16)
    dy = jnp.asarray(_input(shape, 6)).astype(jnp.bfloat16)
    c = shape[-1]
    (y, _, _), vjp = jax.vjp(lambda a: _bn_train(a, jnp.ones(c),
                                                 jnp.zeros(c), 1e-5), x)
    (dx,) = vjp((dy.astype(jnp.float32), jnp.zeros(c), jnp.zeros(c)))
    bn = FastBatchNorm(c, dtype=torch.bfloat16).train()
    with torch.no_grad():
        bn.weight.fill_(1.0)
        bn.bias.zero_()
    tx = nchw(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16) \
        .requires_grad_(True)
    ty = bn(tx)
    assert ty.dtype == torch.bfloat16
    ty.backward(nchw(np.asarray(dy.astype(jnp.float32))).to(torch.bfloat16))
    assert tx.grad.dtype == torch.bfloat16
    want_y = np.asarray(y.astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_allclose(to_nhwc(ty), want_y, atol=2e-2, rtol=1e-2)
    np.testing.assert_allclose(to_nhwc(tx.grad),
                               np.asarray(dx.astype(jnp.float32)),
                               atol=2e-2, rtol=1e-2)


def test_grad_sums_take_a_strided_gradient():
    """The backward makes a strided gradient contiguous before the sums
    and gives what a contiguous one gives."""
    x = torch.from_numpy(_input((3, 4, 5, 6), 7))
    mean, rstd = torch.randn(4), torch.rand(4) + 0.5
    dy = torch.randn(3, 4, 6, 5).transpose(2, 3)
    got = bn_grad_stats(dy, x, mean, rstd)
    want = bn_grad_stats(dy.contiguous(), x, mean, rstd)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w)
    bn = FastBatchNorm(4).train()
    with torch.no_grad():
        bn.weight.fill_(1.0)
        bn.bias.zero_()
    xg = x.clone().requires_grad_(True)
    bn(xg).backward(dy)
    xc = x.clone().requires_grad_(True)
    bn(xc).backward(dy.contiguous())
    torch.testing.assert_close(xg.grad, xc.grad)


# plain versions against JAX's _bn_train: NHWC shapes (ragged C and H*W,
# A = 1, B = 1 in NCHW), a [M, C] and a [N, K, D] feature
PLAIN_SHAPES = [(2, 5, 3, 7), (1, 7, 1, 3), (2, 1, 1, 6), (9, 12), (4, 5, 6)]


@pytest.mark.parametrize('shape', PLAIN_SHAPES)
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('use_bias', [True, False])
def test_plain_versions_match_jax_bn_train(shape, dtype, use_bias):
    """bn_stats (with the running update), bn_apply, bn_grad_stats and
    bn_dx, plain, against ``_bn_train``'s forward and vjp and flax's
    running update (x in ``dtype``, y and dy in f32 as in JAX)."""
    c, eps = shape[-1], 1e-5
    rng = np.random.default_rng(20)
    jdt = getattr(jnp, dtype)
    x = jnp.asarray(_input(shape, 21)).astype(jdt)
    scale = (1 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.3 * rng.standard_normal(c) if use_bias else np.zeros(c)) \
        .astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    ra_mean = (0.1 * rng.standard_normal(c)).astype(np.float32)
    ra_var = rng.uniform(0.5, 1.5, c).astype(np.float32)
    (y, mean, var), vjp = jax.vjp(lambda a, s, b: _bn_train(a, s, b, eps),
                                  x, jnp.asarray(scale), jnp.asarray(bias))
    dx, dscale, dbias = vjp((jnp.asarray(dy), jnp.zeros(c), jnp.zeros(c)))

    cd = 1 if len(shape) == 4 else -1
    tx = _port_layout(np.asarray(x.astype(jnp.float32))).to(getattr(torch,
                                                                  dtype))
    tdy = _port_layout(dy)
    weight = torch.from_numpy(scale)
    tbias = torch.from_numpy(bias) if use_bias else None
    rm, rv = torch.from_numpy(ra_mean.copy()), torch.from_numpy(ra_var.copy())
    t_mean, t_var, rstd, t_scale = bn_stats_reference(tx, weight, eps, cd,
                                                      rm, rv)
    ty = bn_apply_reference(tx, t_mean, rstd, weight, tbias, cd,
                            torch.float32)
    sum_dy, sum_dy_xhat = bn_grad_stats_reference(tdy, tx, t_mean, rstd, cd)
    tdx = bn_dx_reference(tdy, tx, t_mean, rstd, t_scale, sum_dy,
                          sum_dy_xhat, cd)
    assert tdx.dtype == tx.dtype
    for got, want in ((t_mean, mean), (t_var, var), (sum_dy_xhat, dscale),
                      (t_scale, jax.lax.rsqrt(var + eps) * scale),
                      (rm, 0.9 * ra_mean + (1.0 - 0.9) * mean),
                      (rv, 0.9 * ra_var + (1.0 - 0.9) * var)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if use_bias:
        np.testing.assert_allclose(sum_dy.numpy(), np.asarray(dbias), **TOL)
    np.testing.assert_allclose(_jax_layout(ty), np.asarray(y), **TOL)
    tol = TOL if dtype == 'float32' else dict(atol=2e-2, rtol=1e-2)
    np.testing.assert_allclose(_jax_layout(tdx),
                               np.asarray(dx.astype(jnp.float32)), **tol)


def test_eval_bn_backward_matches_autograd_of_the_plain_version():
    """An eval-mode BN stays differentiable: its backward against autograd
    through ``bn_apply_reference``."""
    x = torch.from_numpy(_input((3, 4, 5, 6), 22))
    dy = torch.randn(3, 4, 5, 6, generator=torch.Generator().manual_seed(0))
    bn = FastBatchNorm(4).eval()
    with torch.no_grad():
        bn.weight.copy_(torch.tensor([0.5, 1.0, 1.5, 2.0]))
        bn.bias.copy_(torch.tensor([0.1, -0.2, 0.3, 0.0]))
        bn.running_mean.copy_(torch.tensor([1.0, 2.0, 1.5, 1.2]))
        bn.running_var.copy_(torch.tensor([0.5, 2.0, 1.0, 3.0]))
    grads = []
    for fn in (bn, lambda t: bn_apply_reference(
            t, bn.running_mean, torch.rsqrt(bn.running_var + bn.eps),
            bn.weight, bn.bias)):
        xg = x.clone().requires_grad_(True)
        y = fn(xg)
        grads.append(torch.autograd.grad(y, (xg, bn.weight, bn.bias), dy))
        grads[-1] += (y.detach(),)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_wrappers_take_the_plain_versions_on_the_cpu():
    """On CPU tensors the wrappers are their plain versions, bit for bit,
    and launch nothing."""
    from bpbreid_tpu_torch.ops.cuda.build import launch_counts
    x = torch.from_numpy(_input((2, 3, 4, 5), 23)).to(torch.bfloat16)
    w, b = torch.rand(3) + 0.5, torch.rand(3)
    before = dict(launch_counts)
    got = bn_stats(x, w, 1e-5, sums=True)
    want = bn_stats_reference(x, w, 1e-5, sums=True)
    assert len(got) == len(want) == 6
    for g, v in zip(got, want):
        assert torch.equal(g, v)
    mean, _, rstd = got[:3]
    assert torch.equal(bn_apply(x, mean, rstd, w, b, dtype=torch.float32),
                       bn_apply_reference(x, mean, rstd, w, b,
                                          dtype=torch.float32))
    assert dict(launch_counts) == before
