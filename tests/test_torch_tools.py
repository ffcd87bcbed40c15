"""The tools of bpbreid_tpu_torch against their JAX counterparts, on the
CPU: ``utils/tools.py``, ``utils/imagetools.py``,
``utils/receptive_field.py``, ``utils/model_complexity.py``,
``tools/compute_mean_std.py``, ``tools/profile_summary.py``,
``scripts/get_labels.py`` and ``hyperparameter/``.

- the file helpers, ``read_image`` / ``read_masks`` (equal to JAX's on a
  PNG and a ``.npy``), ``set_random_seed`` (torch's stream too) and
  ``collect_env_info`` (torch's stack, no JAX); ``download_url`` on a
  local ``file://`` URL;
- ``gaussian_heatmaps``, ``compute_receptive_field`` and
  ``compute_mean_std`` (on the synthetic set) equal to JAX's;
- ``compute_model_complexity``: the parameter count equals JAX's to the
  unit on ``osnet_x0_25`` at 64x32 (both heads) and on BPBReID with a
  depth-cut HRNet-W32; the FLOP ratio to XLA's count is printed;
- ``profile_summary``: exact totals and categories on a fabricated
  Chrome trace, and on a CPU ``torch.profiler`` trace the summed self
  time equals ``key_averages``';
- get_labels: the field layout, the box order, the person mask and
  ``generate_labels`` (synthetic backend, with and without a person
  filter) equal to JAX's on PNG images (1e-6); the external backends
  raise ``ImportError`` without their libraries;
- the HPO search: JAX's trial lists, JAX's ``hpo_results.json`` with a
  fake ``train_fn``, and the ClearML client against the fake ``clearml``
  module of tests/test_clearml_service.py.
"""
import json
import os
import random
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpbreid_tpu.data import datasets as jdatasets
from bpbreid_tpu.data.datasets import dataset as jdataset
from bpbreid_tpu.hyperparameter import optimizer as joptimizer
from bpbreid_tpu.scripts import get_labels as jlabels
from bpbreid_tpu.tools.compute_mean_std import compute_mean_std as j_mean_std
from bpbreid_tpu.utils import imagetools as jimagetools
from bpbreid_tpu.utils import receptive_field as jreceptive
from bpbreid_tpu.utils.model_complexity import count_params as j_count_params
from bpbreid_tpu_torch.config import get_default_config
from bpbreid_tpu_torch.data import datasets as tdatasets
from bpbreid_tpu_torch.data.datasets.dataset import write_png
from bpbreid_tpu_torch.hyperparameter import (ClearMLServiceOptimizer,
                                              GridSearch,
                                              HyperParameterOptimizer,
                                              RandomSearch,
                                              clone_task_with_overrides)
from bpbreid_tpu_torch.scripts import get_labels
from bpbreid_tpu_torch.tools import profile_summary
from bpbreid_tpu_torch.tools.compute_mean_std import compute_mean_std
from bpbreid_tpu_torch.utils import imagetools, receptive_field, tools
from bpbreid_tpu_torch.utils.model_complexity import compute_model_complexity
from tests.test_clearml_service import _fake_clearml, _Recorder
from tests.torch_port_helpers import SMALL_W32, limit_torch_threads

limit_torch_threads()


def test_file_helpers_and_readers(tmp_path):
    tools.mkdir_if_missing(str(tmp_path / 'a' / 'b'))
    assert (tmp_path / 'a' / 'b').is_dir()
    tools.write_json({'x': [1, 2]}, str(tmp_path / 'a' / 'x.json'))
    assert tools.read_json(str(tmp_path / 'a' / 'x.json')) == {'x': [1, 2]}
    assert tools.check_isfile(str(tmp_path / 'a' / 'x.json'))
    with pytest.warns(UserWarning, match='No file found'):
        assert not tools.check_isfile(str(tmp_path / 'missing'))
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (9, 5, 3), dtype=np.uint8)
    write_png(str(tmp_path / 'im.png'), img)
    np.testing.assert_array_equal(tools.read_image(str(tmp_path / 'im.png')),
                                  img)
    np.testing.assert_array_equal(
        tools.read_image(str(tmp_path / 'im.png')),
        jdataset.read_image(str(tmp_path / 'im.png')))
    masks = rng.random((6, 4, 3)).astype(np.float32)
    np.save(str(tmp_path / 'm.npy'), masks)
    np.testing.assert_array_equal(tools.read_masks(str(tmp_path / 'm.npy')),
                                  jdataset.read_masks(str(tmp_path / 'm.npy')))


def test_seed_env_info_and_local_download(tmp_path, capsys):
    tools.set_random_seed(3)
    a = (random.random(), np.random.rand(), torch.rand(2))
    tools.set_random_seed(3)
    b = (random.random(), np.random.rand(), torch.rand(2))
    assert a[:2] == b[:2] and torch.equal(a[2], b[2])
    info = tools.collect_env_info()
    assert 'torch: ' in info and 'numpy: ' in info and 'jax' not in info
    assert 'devices: ' in info
    src = tmp_path / 'src.bin'
    src.write_bytes(b'abc' * 1000)
    tools.download_url(src.as_uri(), str(tmp_path / 'dst.bin'))
    assert (tmp_path / 'dst.bin').read_bytes() == src.read_bytes()
    assert '100%' in capsys.readouterr().out


@pytest.mark.parametrize('sigma', [1.0, 2.5])
def test_gaussian_heatmaps_match_jax(sigma):
    rng = np.random.default_rng(1)
    kp = np.concatenate([rng.uniform(0, 8, (5, 2)),
                         rng.uniform(-0.5, 1, (5, 1))], axis=1)
    np.testing.assert_array_equal(
        imagetools.gaussian_heatmaps(kp, 12, 8, sigma),
        jimagetools.gaussian_heatmaps(kp, 12, 8, sigma))
    batch = np.stack([kp, kp[::-1]])
    np.testing.assert_array_equal(
        imagetools.build_gaussian_heatmaps(batch, 12, 8, sigma),
        jimagetools.build_gaussian_heatmaps(batch, 12, 8, sigma))


def test_receptive_field_matches_jax():
    for name in ('RESNET50_SPEC', 'HRNET_STEM_SPEC'):
        spec = getattr(receptive_field, name)
        assert spec == getattr(jreceptive, name)
        assert receptive_field.compute_receptive_field(spec) == \
            jreceptive.compute_receptive_field(spec)
    assert receptive_field.compute_receptive_field(
        receptive_field.HRNET_STEM_SPEC)[-1]['rf'] == 7


def test_compute_mean_std_matches_jax():
    tdatasets.clear_dataset_cache()
    jdatasets.clear_dataset_cache()
    got = compute_mean_std(tdatasets.init_image_dataset(
        'synthetic', mode='train', num_pids=2), max_samples=5)
    want = j_mean_std(jdatasets.init_image_dataset(
        'synthetic', mode='train', num_pids=2), max_samples=5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-12)


def _jax_params(model, *shapes):
    variables = jax.eval_shape(
        lambda *x: model.init(jax.random.PRNGKey(0), *x, train=False),
        *[jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes])
    return variables, j_count_params(variables['params'])


@pytest.mark.parametrize('loss', ['softmax', 'part_based'])
def test_model_complexity_params_match_jax_on_osnet(loss):
    from bpbreid_tpu.models import build_model as j_build
    from bpbreid_tpu_torch.models import build_model
    model = build_model('osnet_x0_25', 10, loss=loss, device='cpu')
    model.train()
    params, flops = compute_model_complexity(model, height=64, width=32,
                                             verbose=True)
    assert model.training
    jm = j_build('osnet_x0_25', 10, loss=loss)
    variables, want = _jax_params(jm, (1, 64, 32, 3))
    assert params == want
    if loss != 'softmax':           # JAX's own test case: the FLOP ratio
        return
    cost = jax.jit(lambda v, x: jm.apply(v, x, train=False)).lower(
        variables, jax.ShapeDtypeStruct((1, 64, 32, 3), jnp.float32)) \
        .cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    print('osnet_x0_25 {}: FlopCounterMode {:,} / XLA (lowered) {:,.0f} = '
          '{:.4f}'.format(loss, flops, cost['flops'], flops / cost['flops']))
    assert 0.5 < flops / cost['flops'] <= 1.0


def test_model_complexity_params_match_jax_on_bpbreid():
    from bpbreid_tpu.models.bpbreid import BPBreID as JBPBreID
    from bpbreid_tpu_torch.models.bpbreid import BPBreID
    kw = dict(num_classes=7, parts_num=5, backbone='hrnet32',
              backbone_stages=SMALL_W32, dim_reduce_output=32)
    params, flops = compute_model_complexity(BPBreID(**kw), height=64,
                                             width=32)
    assert params == _jax_params(JBPBreID(**kw), (1, 64, 32, 3),
                                 (1, 8, 4, 6))[1]
    assert flops > 0


def _trace(events):
    return {'traceEvents': events, 'schemaVersion': 1}


def test_profile_summary_on_a_fabricated_trace(tmp_path, capsys):
    def k(name, ts, dur, cat='kernel'):
        return {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur,
                'pid': 0, 'tid': 7}
    events = [
        k('void reduce_rows_kernel<float>(...)', 0, 10.5),
        k('void attention_pool_kernel<__nv_bfloat16>(...)', 11, 4.25),
        k('sm90_xmma_fprop_implicit_gemm_bf16bf16', 16, 30.0),
        k('sm90_xmma_gemm_bf16bf16_bf16f32', 47, 7.0),
        k('void cudnn::nchwToNhwcKernel<float>(...)', 55, 2.0),
        k('void at::native::reduce_kernel<512, 1>(...)', 58, 1.5),
        k('void at::native::vectorized_elementwise_kernel<4>(...)', 60, 0.75),
        k('Memcpy HtoD (Pageable -> Device)', 61, 3.0, 'gpu_memcpy'),
        k('void cub::DeviceRadixSortOnesweepKernel(...)', 65, 1.0),
        k('aten::conv2d', 0, 99.0, 'cpu_op'),           # not a device event
        k('void reduce_rows_kernel<float>(...)', 70, 1.5),
        {'ph': 'i', 'name': 'marker', 'ts': 3},
    ]
    path = tmp_path / 'run' / 'trace.json'
    path.parent.mkdir()
    path.write_text(json.dumps(_trace(events)))
    assert profile_summary.find_trace(str(tmp_path)) == str(path)
    rows, cats, total, label = profile_summary.summarize(str(path), top=3)
    assert label.startswith('device')
    assert total == 61500
    assert rows[0] == ('sm90_xmma_fprop_implicit_gemm_bf16bf16', 30000, 1)
    assert rows[1] == ('void reduce_rows_kernel<float>(...)', 12000, 2)
    assert dict(cats) == {
        'batch norm': 12000, 'attention pool': 4250, 'convolution': 30000,
        'matmul': 7000, 'layout copy': 2000, 'reduce': 1500,
        'elementwise': 750, 'memcpy/memset': 3000, 'other': 1000}
    profile_summary.main([str(path), '--top', '2'])
    out = capsys.readouterr().out
    assert 'total event time: 0.06' in out and 'category rollup' in out
    with pytest.raises(FileNotFoundError):
        profile_summary.find_trace(str(tmp_path / 'run' / 'none'))


def test_profile_summary_on_a_cpu_profile_equals_key_averages(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    model = torch.nn.Sequential(
        torch.nn.Conv2d(3, 8, 3), torch.nn.BatchNorm2d(8), torch.nn.ReLU(),
        torch.nn.Flatten(), torch.nn.Linear(8 * 14 * 14, 10))
    x = torch.randn(2, 3, 16, 16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            model(x).sum().backward()
    path = str(tmp_path / 'cpu.json')
    prof.export_chrome_trace(path)
    rows, cats, total, label = profile_summary.summarize(path, top=1000)
    assert label.startswith('CPU')
    want = {e.key: e.self_cpu_time_total for e in prof.key_averages()}
    assert total / 1e3 == pytest.approx(sum(want.values()), abs=1e-2)
    for name, ns, _count in rows:
        assert ns / 1e3 == pytest.approx(want[name], abs=1e-2), name
    assert cats['convolution'] > 0 and cats['matmul'] > 0
    assert cats['batch norm'] > 0


@pytest.mark.parametrize('name, cat, want', [
    ('void (anonymous namespace)::ewise_cols_kernel<float>(...)', 'kernel',
     'batch norm'),
    ('cudnn::bn_fw_tr_1C11_kernel_NCHW<float>', 'kernel', 'batch norm'),
    ('sm90_xmma_wgrad_implicit_gemm_bf16bf16', 'kernel', 'convolution'),
    ('void conv_s8_kernel<128, 64>(...)', 'kernel', 'convolution'),
    ('void quantize_nhwc_kernel<__nv_bfloat16>(...)', 'kernel',
     'elementwise'),
    ('ampere_sgemm_128x64_tn', 'kernel', 'matmul'),
    ('Memset (Device)', 'gpu_memset', 'memcpy/memset'),
    ('aten::mkldnn_convolution', 'cpu_op', 'convolution'),
    ('aten::add_', 'cpu_op', 'elementwise'),
    ('_BatchNormEvalBackward', 'cpu_op', 'batch norm'),
    ('aten::empty', 'cpu_op', 'other'),
])
def test_profile_summary_categories(name, cat, want):
    assert profile_summary.categorize(name, cat) == want


@pytest.mark.parametrize('seed', [0, 1])
def test_synthetic_pose_backend_matches_jax(seed):
    image = np.random.default_rng(seed).integers(0, 256, (96, 40, 3),
                                                 dtype=np.uint8)
    got = get_labels.SyntheticPoseBackend(seed=seed)(image)
    assert got.shape == (12, 5, 36)
    np.testing.assert_array_equal(
        got, jlabels.SyntheticPoseBackend(seed=seed)(image))


def test_confidence_fields_boxes_and_person_mask_match_jax():
    rng = np.random.default_rng(7)
    pif = rng.random((17, 5, 12, 8)).astype(np.float32)
    paf = rng.random((19, 9, 12, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        get_labels.extract_confidence_fields(pif, paf),
        jlabels.extract_confidence_fields(pif, paf))
    with pytest.raises(ValueError, match='17 pif'):
        get_labels.extract_confidence_fields(pif[:5], paf)
    boxes = [rng.uniform(0, 30, 4) for _ in range(6)]
    assert get_labels.order_boxes_by_center_distance((40, 20), boxes) == \
        jlabels.order_boxes_by_center_distance((40, 20), boxes)
    masks = [rng.random((40, 20)) > 0.5 for _ in range(6)]
    for classes in ([16, 0, 0, 3, 0, 0], [1, 2, 3, 4, 5, 6]):
        inst = types.SimpleNamespace(image_size=(40, 20), pred_boxes=boxes,
                                     pred_classes=np.asarray(classes),
                                     pred_masks=masks)
        np.testing.assert_array_equal(get_labels.select_person_mask(inst),
                                      jlabels.select_person_mask(inst))
    with pytest.raises(RuntimeError, match='any masks'):
        get_labels.select_person_mask(types.SimpleNamespace(
            image_size=(4, 4), pred_boxes=[], pred_classes=[],
            pred_masks=[]))


def test_external_backends_are_import_gated(monkeypatch):
    monkeypatch.setitem(sys.modules, 'openpifpaf', None)
    monkeypatch.setitem(sys.modules, 'detectron2', None)
    with pytest.raises(ImportError, match='openpifpaf'):
        get_labels.OpenPifPafBackend()
    with pytest.raises(ImportError, match='detectron2'):
        get_labels.MaskRCNNBackend()


class _TopHalf(get_labels.SegmentationBackend):
    def __call__(self, image):
        m = np.zeros(image.shape[:2], np.float32)
        m[:image.shape[0] // 2] = 1.0
        return m


def test_generate_labels_matches_jax_on_png_images(tmp_path):
    """PNG data under ``.jpg`` names (the default glob): both decoders
    read the same pixels."""
    rng = np.random.default_rng(5)
    for root in ('port', 'jax'):
        d = tmp_path / root / 'bounding_box_train'
        d.mkdir(parents=True)
        for i in range(3):
            write_png(str(d / '000{}_c1s1_00000{}_00.jpg'.format(i, i)),
                      np.random.default_rng(i).integers(
                          0, 256, (64 + 8 * i, 32, 3), dtype=np.uint8))
    del rng
    for masks_dir, seg in (('pifpaf', None),
                           ('pifpaf_maskrcnn_filtering', _TopHalf())):
        got = get_labels.generate_labels(
            str(tmp_path / 'port'), masks_dir=masks_dir, seg_backend=seg)
        want = jlabels.generate_labels(
            str(tmp_path / 'jax'), masks_dir=masks_dir, seg_backend=seg)
        assert [os.path.relpath(p, str(tmp_path / 'port')) for p in got] == \
            [os.path.relpath(p, str(tmp_path / 'jax')) for p in want]
        for g, w in zip(got, want):
            a, b = np.load(g), np.load(w)
            assert a.shape[0] == 36 and a.shape == b.shape
            np.testing.assert_allclose(a, b, atol=1e-6)


def test_search_strategies_give_jax_trials():
    space = {'train.lr': [0.1, 0.3], 'train.batch_size': [8, 16, 32]}
    assert list(GridSearch(space).trials()) == \
        list(joptimizer.GridSearch(space).trials())
    assert list(GridSearch(space).trials(max_trials=4)) == \
        list(joptimizer.GridSearch(space).trials(max_trials=4))
    rspace = {'train.lr': (0.001, 0.1), 'train.batch_size': (8, 64),
              'loss.name': ['softmax', 'triplet']}
    assert list(RandomSearch(rspace, seed=3).trials(7)) == \
        list(joptimizer.RandomSearch(rspace, seed=3).trials(7))


def test_optimize_writes_jax_results(tmp_path):
    from bpbreid_tpu.config import get_default_config as j_default_config

    def fake_train(cfg):
        return {'rank1': cfg.train.lr * cfg.train.batch_size, 'mAP': 0.5,
                'ssmd': 0.0}
    space = {'train.lr': [0.1, 0.3, 0.2], 'train.batch_size': [8, 4]}
    best = HyperParameterOptimizer(
        get_default_config(), GridSearch(space), save_dir=str(tmp_path / 'p'),
        train_fn=fake_train).optimize()
    want = joptimizer.HyperParameterOptimizer(
        j_default_config(), joptimizer.GridSearch(space),
        save_dir=str(tmp_path / 'j'), train_fn=fake_train).optimize()
    assert best == want and best['overrides'] == {'train.lr': 0.3,
                                                  'train.batch_size': 8}
    assert (tmp_path / 'p' / 'hpo_results.json').read_text() == \
        (tmp_path / 'j' / 'hpo_results.json').read_text()


def test_clearml_service_against_a_fake_sdk(monkeypatch):
    monkeypatch.setitem(sys.modules, 'clearml', None)
    opt = ClearMLServiceOptimizer('tmpl-1', {'train.batch_size': [32, 64]})
    with pytest.raises(ImportError, match='in-process'):
        opt.launch()
    rec = _Recorder()
    clearml, automation = _fake_clearml(rec)
    monkeypatch.setitem(sys.modules, 'clearml', clearml)
    monkeypatch.setitem(sys.modules, 'clearml.automation', automation)
    task = clone_task_with_overrides(
        'tmpl-7', {'loss.part_based.name': 'part_max_triplet_loss'},
        execution_queue='gpu-queue', name='trial-0')
    assert task.params == {
        'General/loss/part_based/name': 'part_max_triplet_loss'}
    assert ('Task.enqueue', 'trial-0', 'gpu-queue') in rec.calls
    opt = ClearMLServiceOptimizer(
        'tmpl-42', {'loss.part_based.name': ['a', 'b'],
                    'train.batch_size': (32, 128)}, total_max_jobs=4)
    assert opt.launch() == ['exp-1', 'exp-2']
    hpo_kw = dict((c[0], c) for c in rec.calls)['HPO.__init__'][1]
    assert hpo_kw['objective_metric_title'] == 'Test/rank1'
    ranges = {r.name: r for r in hpo_kw['hyper_parameters']}
    assert ranges['General/train/batch_size'].max_value == 128
    assert opt.launch(run_as_service=True) is None
    assert ('task.execute_remotely', 'services', True) in rec.calls
