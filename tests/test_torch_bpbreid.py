"""bpbreid_tpu_torch BPBReID vs bpbreid_tpu, depth-reduced HRNet-W32 at
full widths, 64x32 input, five parts.

All six outputs are compared on the fused-pool path (the slice's
configuration: use_pallas_pooling, multires off, reaching
fused_attention_pool) and on the default multires path. The weights
cross over with ``utils/weights.py``, which must fill every parameter
and buffer of the port.

Tolerances (f32): 1e-3 for the whole model (the HRNet sums run in
another order); visibility scores are boolean and must match exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpbreid_tpu.models.bpbreid import BPBreID as JBPBreID
from bpbreid_tpu_torch.models.bpbreid import BPBreID as TBPBreID
from bpbreid_tpu_torch.utils.weights import (jax_variables_to_state_dict,
                                             load_jax_variables)
from tests.torch_port_helpers import (SMALL_W32, nchw, randomize_variables,
                                      to_nhwc, to_np, limit_torch_threads)

limit_torch_threads()

KW = dict(num_classes=7, parts_num=5, backbone='hrnet32',
          backbone_stages=SMALL_W32, dim_reduce_output=32)


@pytest.fixture(scope='module')
def inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 64, 32, 3)).astype(np.float32)
    masks = rng.uniform(size=(2, 16, 8, 6)).astype(np.float32)
    jm = JBPBreID(**KW)
    variables = randomize_variables(
        jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x),
                         jnp.asarray(masks)), 0)
    return x, masks, variables


def run_both(inputs, dtype='float32', **flags):
    x, masks, variables = inputs
    jm = JBPBreID(dtype=getattr(jnp, dtype), **KW, **flags)
    want = jax.jit(jm.apply)(variables, jnp.asarray(x), jnp.asarray(masks))
    tm = TBPBreID(dtype=getattr(torch, dtype), **KW, **flags)
    load_jax_variables(tm, variables)
    with torch.inference_mode():
        got = tm.eval()(nchw(x), nchw(masks))
    return want, got


def _spatial(t):
    """Port map -> JAX layout ([N,K,H,W] -> [N,H,W,K], [N,H,W] as is)."""
    return to_nhwc(t) if t.dim() == 4 else to_np(t)


def assert_outputs_match(want, got, atol=1e-3):
    emb, vis, cls, pix, spatial, masks = range(6)
    for i in (emb, cls):
        assert set(got[i]) == set(want[i])
        for k in want[i]:
            np.testing.assert_allclose(to_np(got[i][k]), to_np(want[i][k]),
                                       atol=atol, rtol=atol, err_msg=k)
    assert set(got[vis]) == set(want[vis])
    for k in want[vis]:
        assert got[vis][k].dtype == torch.bool
        np.testing.assert_array_equal(to_np(got[vis][k]),
                                      to_np(want[vis][k]), err_msg=k)
    for k in want[masks]:
        np.testing.assert_allclose(_spatial(got[masks][k]),
                                   to_np(want[masks][k]), atol=atol,
                                   err_msg=k)
    if want[pix] is None:              # learnable attention off
        assert got[pix] is None
    else:
        np.testing.assert_allclose(to_nhwc(got[pix]), to_np(want[pix]),
                                   atol=atol, rtol=atol)
    if got[spatial] is not None:
        np.testing.assert_allclose(to_nhwc(got[spatial]),
                                   to_np(want[spatial]), atol=atol)


def test_fused_pool_path_matches_jax(inputs):
    want, got = run_both(inputs, use_pallas_pooling=True,
                         multires_pooling=False)
    assert tuple(got[4].shape) == (2, 1920, 16, 8)
    assert_outputs_match(want, got)


def test_multires_path_matches_jax(inputs):
    want, got = run_both(inputs)
    assert got[4] is None          # the concat map is never built
    assert_outputs_match(want, got)


def test_weights_fill_every_port_parameter_and_buffer(inputs):
    _, _, variables = inputs
    sd = jax_variables_to_state_dict(variables)
    tm = TBPBreID(**KW)
    own = tm.state_dict()
    assert set(sd) == set(own)
    load_jax_variables(tm, variables)
    for key, value in tm.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), sd[key], err_msg=key)
    # layout: conv kernels HWIO -> OIHW, dense kernels IO -> OI
    kernel = variables['params']['pixel_classifier']['classifier']['kernel']
    np.testing.assert_array_equal(
        own['pixel_classifier.classifier.weight'].numpy()[:, :, 0, 0],
        np.asarray(kernel)[0, 0].T)
    for key in ('pixel_classifier.bn.running_mean',
                'parts_identity_classifier.4.bn.weight',
                'foreground_after_pooling_dim_reduce.layers.1.running_var',
                'backbone_appearance_feature_extractor.stage4.0.branches.3.1'
                '.conv2.weight'):
        assert key in own, key
    # a module the variables do not cover is refused
    bigger = TBPBreID(**{**KW, 'parts_num': 6})
    with pytest.raises((KeyError, ValueError)):
        load_jax_variables(bigger, variables)
