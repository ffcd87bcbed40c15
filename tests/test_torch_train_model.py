"""bpbreid_tpu_torch BPBReID in train mode vs bpbreid_tpu
``apply(train=True, mutable=['batch_stats'])``: depth-reduced HRNet-W32
at full widths, 64x32 input, batch 8 (2 identities x 4 instances), five
parts.

Compared: all six outputs (embeddings, training visibility,
id_cls_scores, pixel logits, masks) and every mutated BN running
statistic, including the pixel classifier's virtual multires
statistics. Tolerance (f32): 1e-3, as for the eval model (the HRNet sums
run in another order); visibility must match exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpbreid_tpu.models.bpbreid import BPBreID as JBPBreID
from bpbreid_tpu_torch.models.bpbreid import BPBreID as TBPBreID
from bpbreid_tpu_torch.utils.weights import (jax_variables_to_state_dict,
                                             load_jax_variables)
from tests.test_torch_bpbreid import assert_outputs_match
from tests.torch_port_helpers import SMALL_W32, nchw, randomize_variables

KW = dict(num_classes=7, parts_num=5, backbone='hrnet32',
          backbone_stages=SMALL_W32, dim_reduce_output=32)


@pytest.fixture(scope='module')
def inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 64, 32, 3)).astype(np.float32)
    masks = rng.uniform(size=(8, 16, 8, 6)).astype(np.float32)
    jm = JBPBreID(**KW)
    variables = randomize_variables(
        jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x[:2]),
                         jnp.asarray(masks[:2])), 1)
    return x, masks, variables


def run_train(inputs, **flags):
    x, masks, variables = inputs
    jm = JBPBreID(**KW, **flags)
    want, mutated = jax.jit(lambda v, a, m: jm.apply(
        v, a, m, train=True, mutable=['batch_stats']))(
        variables, jnp.asarray(x), jnp.asarray(masks))
    tm = load_jax_variables(TBPBreID(**KW, **flags), variables).train()
    got = tm(nchw(x), nchw(masks))
    return want, jax.device_get(mutated), tm, got


def assert_batch_stats_match(mutated, tm, atol=1e-4):
    want = jax_variables_to_state_dict(mutated)
    own = tm.state_dict()
    assert len(want) == 2 * 110          # every FastBatchNorm, pixel BN too
    for key, value in want.items():
        np.testing.assert_allclose(own[key].numpy(), value, atol=atol,
                                   rtol=1e-4, err_msg=key)


def test_train_mode_multires_matches_jax(inputs):
    """The train recipe's path: multires pooling, virtual pixel-BN
    statistics, batch statistics in every BN."""
    want, mutated, tm, got = run_train(inputs)
    assert got[4] is None
    assert_outputs_match(want, got)
    assert_batch_stats_match(mutated, tm)
    # the running statistics moved away from their loaded values
    assert not np.allclose(
        tm.state_dict()['pixel_classifier.bn.running_var'].numpy(),
        inputs[2]['batch_stats']['pixel_classifier']['bn']['var'])


def test_train_mode_materialized_matches_jax(inputs):
    """The materialized concat path, with the continuous training
    visibility (``training_binary_visibility_score=False``)."""
    want, mutated, tm, got = run_train(
        inputs, multires_pooling=False,
        training_binary_visibility_score=False)
    vis = 1
    for k in want[vis]:
        assert got[vis][k].dtype == torch.float32, k
        np.testing.assert_allclose(got[vis][k].detach().numpy(),
                                   np.asarray(want[vis][k], np.float32),
                                   atol=1e-3, err_msg=k)
    # the other outputs as on the binary path (visibility checked above)
    assert_outputs_match((want[0], {}, *want[2:]), (got[0], {}, *got[2:]))
    assert_batch_stats_match(mutated, tm)


def test_fused_pool_path_is_differentiable_on_cpu(inputs):
    """On CPU tensors K2's plain version runs, and training through the
    ``use_pallas_pooling`` path gives the gradients of the plain pooling
    path (the JAX package has no backward for K2)."""
    x, masks, variables = inputs
    grads = {}
    for fused in (True, False):
        tm = load_jax_variables(TBPBreID(**KW, use_pallas_pooling=fused,
                                         multires_pooling=False),
                                variables).train()
        emb, _, cls, pix = tm(nchw(x), nchw(masks))[:4]
        loss = emb['parts'].float().square().mean() \
            + cls['globl'].float().square().mean() \
            + pix.float().square().mean()
        loss.backward()
        grads[fused] = {n: p.grad.clone() for n, p in tm.named_parameters()
                        if p.grad is not None}
    assert set(grads[True]) == set(grads[False])
    for name in ('pixel_classifier.classifier.weight',
                 'backbone_appearance_feature_extractor.conv1.weight'):
        assert grads[True][name].abs().max() > 0, name
    for name, g in grads[False].items():
        torch.testing.assert_close(grads[True][name], g, atol=1e-5,
                                   rtol=1e-4, msg=name)
