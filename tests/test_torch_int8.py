"""Calibrated int8 eval of bpbreid_tpu_torch (ops/quant.py, the int8
modes of models/common.py) against bpbreid_tpu's, one operation or block
at a time. Inputs come from a numpy seed. The quantization is exact
arithmetic, so it is held tightly: the int32 accumulators, the s8
operands and the weight scales bit-equal, the activation scales and
ranges within 1e-6 (the percentile interpolates in f32 as
``jnp.quantile`` does), a PConv and a ResLayer within 1e-6 of JAX (the
ResLayer against JAX's eager run: XLA's jitted batch norm contracts to an
FMA, see tests/test_torch_int8_model.py). The whole small model is held
in tests/test_torch_int8_model.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpbreid_tpu.models import common as jcommon
from bpbreid_tpu.ops import quant as jq
from bpbreid_tpu_torch.models import common as tcommon
from bpbreid_tpu_torch.ops import quant as tq
from bpbreid_tpu_torch.ops.cuda.conv_s8 import conv_s8_accumulate
from bpbreid_tpu_torch.utils.weights import load_jax_variables
from tests.torch_port_helpers import (limit_torch_threads, nchw,
                                      port_variables, to_nhwc)

limit_torch_threads()

@pytest.mark.parametrize('k,stride,gran,groups', [
    (1, 1, 'per_tensor', 1), (3, 1, 'per_channel', 1),
    (3, 2, 'per_tensor', 2), (1, 2, 'per_channel', 2),
    (3, 2, 'per_channel_floor4', 1)])
def test_quant_conv_matches_jax(k, stride, gran, groups):
    rng = np.random.default_rng(k * 10 + stride + groups)
    x = rng.normal(size=(2, 9, 7, 6)).astype(np.float32)
    w = rng.normal(size=(k, k, 6 // groups, 10)).astype(np.float32)
    amax = np.abs(x).max(axis=(0, 1, 2)) * rng.uniform(0.5, 1.0, 6) \
        .astype(np.float32)
    pad = ((k // 2, k // 2),) * 2
    with jq.int8_inference(act_granularity=gran):
        jsx = jq.act_scale_from_amax(jnp.asarray(amax))
        jy = np.asarray(jq.quant_conv(jnp.asarray(x), jnp.asarray(w),
                                      (stride, stride), pad, jsx,
                                      groups=groups, out_dtype=jnp.float32))
        jxq = jq.quantize_static(jnp.asarray(x), jsx)
        jwq, jsw = jq._quantize_weight_per_channel(
            jq._fold_act_scale(jnp.asarray(w), jxq.scale, groups))
        jacc = np.asarray(jax.lax.conv_general_dilated(
            jxq.q, jwq, (stride, stride), pad,
            dimension_numbers=('NHWC', 'HWIO', 'NHWC'),
            feature_group_count=groups, preferred_element_type=jnp.int32))
    xt = nchw(x)
    wt = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous()
    with tq.int8_inference(act_granularity=gran):
        tsx = tq.act_scale_from_amax(torch.from_numpy(amax))
        ty = tq.quant_conv(xt, wt, stride, k // 2, tsx, groups,
                           torch.float32)
        txq = tq.quantize_static(xt, tsx)
        tw, tsw = tq.quant_weights(wt, txq.scale, groups, txq.q.shape[-1])
        tacc = conv_s8_accumulate(txq.q, tw, k, stride, k // 2, 6, groups)
    np.testing.assert_array_equal(txq.q[..., :6].numpy(), np.asarray(jxq.q))
    assert not txq.q[..., 6:].any()
    np.testing.assert_array_equal(
        tw.view(10, k, k, -1)[..., :6 // groups].numpy(),
        np.asarray(jwq).transpose(3, 0, 1, 2))
    np.testing.assert_array_equal(tsw.numpy(), np.asarray(jsw))
    np.testing.assert_array_equal(tacc.permute(0, 2, 3, 1).numpy(), jacc)
    np.testing.assert_allclose(to_nhwc(ty), jy, rtol=1e-6, atol=0)


def test_quantize_static_scales_and_calibration_ranges_match_jax():
    rng = np.random.default_rng(1)
    x = (3 * rng.normal(size=(3, 11, 7, 5))).astype(np.float32)
    amax = np.asarray([160.0, 1.0, 0.0, 40.0, 3.0], np.float32)
    for gran in ('per_tensor', 'per_channel', 'per_channel_floor16'):
        with jq.int8_inference(act_granularity=gran):
            js = np.asarray(jq.act_scale_from_amax(jnp.asarray(amax)))
            jqt = jq.quantize_static(jnp.asarray(x), js)
            jd = np.asarray(jq.dequantize(jqt, jnp.float32))
        with tq.int8_inference(act_granularity=gran):
            ts = tq.act_scale_from_amax(torch.from_numpy(amax))
            tqt = tq.quantize_static(nchw(x), ts)
            td = to_nhwc(tq.dequantize(tqt, torch.float32))
        np.testing.assert_allclose(ts.numpy(), js, rtol=1e-6)
        np.testing.assert_array_equal(tqt.q[..., :5].numpy(),
                                      np.asarray(jqt.q))
        np.testing.assert_allclose(td, jd, rtol=1e-6)
    for pct in (100.0, 99.9):
        with jq.int8_calibration(pct):
            ja = np.asarray(jq.calib_amax(jnp.asarray(x)))
        with tq.int8_calibration(pct):
            ta = tq.calib_amax(nchw(x)).numpy()
        np.testing.assert_allclose(ta, ja, rtol=1e-6)


def test_pconv_calibrate_then_int8_matches_jax():
    """As tests/test_quant.py:43: calibration runs the float conv and
    records |x|max (a running max); int8 then differs from float at the
    quantization scale; an uncalibrated conv takes the dynamic scale,
    with the same result on the calibration batch."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    jm = jcommon.PConv(8, (3, 3), padding=((1, 1), (1, 1)), use_bias=True)
    v = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    v['params']['bias'] = rng.normal(size=8).astype(np.float32)
    with jq.int8_calibration():
        _, jqv = jm.apply(v, jnp.asarray(x), mutable=['quant'])
    with jq.int8_inference():
        jy = np.asarray(jm.apply({**v, **jqv}, jnp.asarray(x)))
    tm = tcommon.PConv(4, 8, 3, padding=1, bias=True)
    load_jax_variables(tm, v)
    xt = nchw(x)
    with torch.no_grad():
        yf = tm(xt)
        with tq.int8_calibration():
            yc = tm(xt)
            tm(0.5 * xt)
        with tq.int8_inference():
            yq = tm(xt)
    np.testing.assert_array_equal(yc.numpy(), yf.numpy())
    np.testing.assert_allclose(tm.act_amax.numpy(),
                               np.asarray(jqv['quant']['act_amax']),
                               rtol=1e-6)
    np.testing.assert_allclose(to_nhwc(yq), jy, rtol=1e-6, atol=1e-6)
    assert (yq - yf).abs().max() > 0
    assert (yq - yf).abs().max() <= 0.05 * yf.abs().max()
    assert 'act_amax' not in tm.state_dict()
    tm2 = tcommon.PConv(4, 8, 3, padding=1, bias=True)
    load_jax_variables(tm2, v)
    with torch.no_grad(), tq.int8_inference():
        yd = tm2(xt)
    np.testing.assert_allclose(yd.numpy(), yq.numpy(), atol=1e-6)
    # a skipped conv is the float conv
    tm.quant_path = 'stem/conv'
    with torch.no_grad(), tq.int8_inference(skip_patterns=('stem',)):
        np.testing.assert_array_equal(tm(xt).numpy(), yf.numpy())


def test_reslayer_producer_quant_matches_consumer_and_jax():
    """As tests/test_quant.py:116: blocks returning a QTensor quantize
    exactly as the next block would; per-conv int8 is untouched by the
    knob. Both against JAX's eager run (no FMA contraction), 1e-6."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 8, 8, 16)).astype(np.float32)
    layers = {q: tcommon.ResLayer(tcommon.BasicBlock, 16, 16, 3,
                                  quant_blocks=q).eval()
              for q in (True, False)}
    jlayer = jcommon.ResLayer(jcommon.BasicBlock, 16, 3)
    tcommon.init_parameters(layers[True], torch.Generator().manual_seed(0))
    v = port_variables(jlayer, layers[True], jnp.asarray(x))
    load_jax_variables(layers[False], v)
    xt = nchw(x)
    for shared in (True, False):
        outs = {}
        for q, layer in layers.items():
            with torch.no_grad():
                with tq.int8_calibration():
                    layer(xt)
                with tq.int8_inference(shared=shared):
                    outs[q] = layer(xt)
        torch.testing.assert_close(outs[True], outs[False], rtol=0, atol=0)
        with jax.disable_jit():
            with jq.int8_calibration():
                _, qv = jlayer.apply(v, jnp.asarray(x), mutable=['quant'])
            with jq.int8_inference(shared=shared):
                jy = np.asarray(jlayer.apply({**v, **qv}, jnp.asarray(x)))
        np.testing.assert_allclose(to_nhwc(outs[True]), jy, rtol=1e-6,
                                   atol=1e-6)
