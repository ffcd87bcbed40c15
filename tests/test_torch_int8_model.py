"""Calibrated int8 eval of a small BPBReID (HRNet-W32 at full widths,
depth cut to ``SMALL_W32``) in bpbreid_tpu_torch against bpbreid_tpu:
the calibrated activation ranges, the int8 embeddings on JAX's ranges,
and the fully-quantized stem. The operations and blocks are held in
tests/test_torch_int8.py.

The ranges are held within 1e-5 of each buffer's largest value (the
float convs of calibration sum in other orders). The embeddings are
compared on weights whose batch norms normalize exactly in f32
(``exact_bn_variables``): XLA's jitted BN contracts ``(x - mean) * s +
bias`` into an FMA and its f32 ``rsqrt`` differs from torch's by an ulp
in about a third of the values, so with general statistics one ulp
separates the frameworks' BN outputs in about a third of the elements; a
value within that ulp of a rounding boundary of the next quantize lands
on another s8 value, and the difference grows through the layers that
follow. Measured on this model with seeded general statistics: JAX's own
jitted and eager int8 runs 7.0e-3 apart in rel. L2 of ``bn_foreg``, the
port 1.6e-2 from JAX's jitted run and 6.2e-7 from its eager run with
the float stem. On exact BN the port is held to 1e-3 of JAX's jitted
int8 (measured 5e-6), and the test prints the share of s8 values that
differ in the branch outputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpbreid_tpu.models.bpbreid import BPBreID as JBPBreID
from bpbreid_tpu.ops import quant as jq
from bpbreid_tpu_torch.models import common as tcommon
from bpbreid_tpu_torch.models.bpbreid import BPBreID as TBPBreID
from bpbreid_tpu_torch.ops import quant as tq
from bpbreid_tpu_torch.utils.weights import _walk, load_jax_variables
from tests.torch_port_helpers import (SMALL_W32, exact_bn_variables,
                                      limit_torch_threads, nchw,
                                      port_variables, to_np)

limit_torch_threads()

KW = dict(num_classes=7, parts_num=5, backbone='hrnet32',
          backbone_stages=SMALL_W32, dim_reduce_output=32,
          use_pallas_pooling=True, multires_pooling=False)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


@pytest.fixture(scope='module')
def small_bpbreid():
    """The small BPBReID of both packages on the same weights, each
    calibrated on the same batch (99.9th percentile), and JAX's int8
    outputs with the branch outputs' QTensors."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 64, 32, 3)).astype(np.float32)
    tmodel = TBPBreID(**KW).eval()
    tcommon.init_parameters(tmodel, torch.Generator().manual_seed(0))
    jmodel = JBPBreID(**KW)
    v = exact_bn_variables(
        port_variables(jmodel, tmodel, jnp.zeros((2, 64, 32, 3))), 0)
    load_jax_variables(tmodel, v)
    with jq.int8_calibration(99.9):
        _, qv = jax.jit(lambda v, x: jmodel.apply(v, x, mutable=['quant']))(
            v, jnp.asarray(x))
    qv = jax.device_get(qv)
    with torch.inference_mode(), tq.int8_calibration(99.9):
        tmodel(nchw(x))
    return {'x': x, 'v': v, 'quant': qv, 'jmodel': jmodel, 'tmodel': tmodel}


def _amax_buffers(model):
    return {'{}.{}'.format(n, k): b for n, m in model.named_modules()
            for k, b in m._buffers.items() if tq._is_amax(k)}


def test_small_bpbreid_calibration_matches_jax(small_bpbreid):
    got = _amax_buffers(small_bpbreid['tmodel'])
    want = {'.'.join(p): a for p, a in _walk(small_bpbreid['quant']['quant'])}
    assert got.keys() == want.keys() and len(got) > 100
    for key, a in want.items():
        # relative to the buffer's largest range: f32 float convs in other
        # orders move the recorded values by about 1e-6 of it
        err = np.abs(got[key].numpy() - a).max() / np.abs(a).max()
        assert err <= 1e-5, (key, err)


@pytest.mark.parametrize('skip', [(), tq.DEFAULT_SKIP])
def test_int8_embeddings_with_jax_ranges_match_jax(small_bpbreid, skip):
    """JAX's ``quant`` collection carried into the port; ``skip=()`` is the
    fully-quantized graph (the stem's 3-channel input padded to 32). Held
    to 1e-3 rel. L2, every s8 value of the branch outputs equal; the int8
    graph must move the embeddings off the float ones by more than 1e-3."""
    s = small_bpbreid
    jmodel, x = s['jmodel'], jnp.asarray(s['x'])
    with jq.int8_inference(skip_patterns=skip):
        jout, inter = jax.jit(lambda v, x: jmodel.apply(
            v, x, mutable=['intermediates'],
            capture_intermediates=lambda m, _: 'branches.' in (m.name or '')
        ))({**s['v'], **s['quant']}, x)
    tmodel = load_jax_variables(TBPBreID(**KW), {**s['v'], **s['quant']})
    tmodel.eval()
    captured = {}
    hooks = [m.register_forward_hook(
        lambda mod, _, out, name=name: captured.__setitem__(name, out))
        for name, m in tmodel.named_modules()
        if name.rsplit('.', 2)[-2:-1] == ['branches']]
    with torch.inference_mode():
        with tq.int8_inference(skip_patterns=skip):
            tout = tmodel(nchw(s['x']))
        for h in hooks:
            h.remove()
        tfloat = tmodel(nchw(s['x']))
    backbone = jax.device_get(
        inter['intermediates']['backbone_appearance_feature_extractor'])
    n_diff = n_all = 0
    for name, qt in captured.items():
        path = name.split('.')          # ...stage2.0.branches.1
        jq_out = backbone['{}.{}'.format(path[-4], path[-3])][
            'branches.{}'.format(path[-1])]['__call__'][0]
        got = qt.q[..., :qt.channels].numpy()
        n_diff += int((got != np.asarray(jq_out.q)).sum())
        n_all += got.size
    print('s8 values of the branch outputs that differ from JAX: {} of {} '
          '({:.2e})'.format(n_diff, n_all, n_diff / n_all))
    assert n_all > 0 and n_diff == 0
    for key in ('bn_foreg', 'parts'):
        err = _rel(to_np(tout[0][key]), to_np(jout[0][key]))
        to_float = _rel(to_np(tout[0][key]), to_np(tfloat[0][key]))
        print(key, 'rel. L2 to JAX int8', err, 'to the float model', to_float)
        assert err <= 1e-3 < to_float, (key, err, to_float)
    agree = (to_np(tout[1]['parts']) == to_np(jout[1]['parts'])).mean()
    print('parts visibility agreement', agree)
    assert agree == 1.0


def test_fully_quantized_stem_runs_int8(small_bpbreid):
    """``int8_skip_patterns []``: the stem's convs run int8 too (their
    input, 3 channels, padded to 32 in the s8 copy); with the default
    skips they stay float, so they differ."""
    model, x = small_bpbreid['tmodel'], nchw(small_bpbreid['x'])
    stem = model.backbone_appearance_feature_extractor.conv1
    seen = {}
    hook = stem.register_forward_hook(
        lambda m, inp, out: seen.setdefault(len(seen), out))
    with torch.inference_mode():
        with tq.int8_inference(skip_patterns=()):
            model(x)
        with tq.int8_inference():
            model(x)
        ref = stem(x)
    hook.remove()
    assert stem.quant_path == 'backbone_appearance_feature_extractor/conv1'
    torch.testing.assert_close(seen[1], ref, rtol=0, atol=0)
    # quantization noise, and the clipping of the 99.9th percentile
    err = _rel(to_np(seen[0]), to_np(ref))
    assert 0 < err <= 5e-2, err
