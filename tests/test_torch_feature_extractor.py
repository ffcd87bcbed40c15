"""The inference path of bpbreid_tpu_torch vs the JAX package's, on the
CPU: ``FeatureExtractor`` (arrays of mixed sizes, PNG paths, external
masks), ``extract_reid_features`` and the CLI's ``--inference-enabled``,
and the port's PNG decoder against ``cv2.imread``.

Both extractors load the same torchreid file (seeded JAX variables of a
BPBReID on resnet18 at 64x32, the serving configuration: fused pooling,
multires off), in f32: embeddings and part masks to 1e-4, visibility
equal. The resize is bit-equal to ``cv2.resize`` and the PNG decoder to
``cv2.imread``, so both models see the same pixels.
"""
import os
import struct
import sys
import types
import zlib

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from bpbreid_tpu.config import get_default_config as j_default_config
from bpbreid_tpu.models.bpbreid import BPBreID as JBPBreID
from bpbreid_tpu.ops.masks import masks_preprocess_all
from bpbreid_tpu.tools.extract_part_based_features import \
    extract_reid_features as j_extract_reid_features
from bpbreid_tpu.tools.feature_extractor import \
    FeatureExtractor as JFeatureExtractor
from bpbreid_tpu.utils.torch_weights import flax_to_torch
from bpbreid_tpu_torch.config import get_default_config
from bpbreid_tpu_torch.constants import PARTS
from bpbreid_tpu_torch.data.datasets import clear_dataset_cache
from bpbreid_tpu_torch.data.datasets.dataset import read_image
from bpbreid_tpu_torch.models.bpbreid import BPBreID as TBPBreID
from bpbreid_tpu_torch.scripts import main as cli
from bpbreid_tpu_torch.tools import FeatureExtractor, extract_reid_features
from tests.torch_port_helpers import (limit_torch_threads,
                                      randomize_variables, to_nhwc, to_np)

limit_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, 'configs/bpbreid/bpbreid_synthetic_smoke.yaml')
KW = dict(num_classes=7, parts_num=5, backbone='resnet18',
          dim_reduce_output=32, use_pallas_pooling=True,
          multires_pooling=False)
SIZES = [(80, 40), (50, 30), (64, 32), (121, 45)]     # (H, W)


def _configs():
    out = []
    for cfg in (j_default_config(), get_default_config()):
        cfg.data.height, cfg.data.width = 64, 32
        cfg.model.bpbreid.masks.preprocess = 'five_v'
        out.append(cfg)
    return out


@pytest.fixture(scope='module')
def rig(tmp_path_factory):
    rng = np.random.default_rng(0)
    jm = JBPBreID(**KW)
    variables = randomize_variables(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((2, 64, 32, 3)),
        jnp.zeros((2, 16, 8, 6))), 0)
    tmp = tmp_path_factory.mktemp('inference')
    path = str(tmp / 'bpbreid_resnet18.pth')
    torch.save({'state_dict': {
        k: torch.from_numpy(np.ascontiguousarray(v))
        for k, v in flax_to_torch(variables).items()}}, path)
    jcfg, cfg = _configs()
    # an engine-like namespace spares the JAX extractor its own (eager)
    # init; the port's extractor loads the file
    spec = masks_preprocess_all['five_v']
    mc = jcfg.model.bpbreid.masks
    jengine = types.SimpleNamespace(
        model=jm, mask_kwargs=dict(
            grouping_matrix=spec.matrix, combine=spec.combine,
            background_strategy=mc.background_computation_strategy,
            softmax_weight=mc.softmax_weight,
            mask_filtering_threshold=mc.mask_filtering_threshold),
        state=types.SimpleNamespace(params=variables['params'],
                                    batch_stats=variables['batch_stats']))
    want = JFeatureExtractor(jcfg, engine=jengine)
    got = FeatureExtractor(cfg, model_path=path, model=TBPBreID(**KW),
                           device='cpu')
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for h, w in SIZES]
    folder = tmp / 'crops'
    os.makedirs(folder / 'sub')
    paths = []
    for i, img in enumerate(images):
        p = str(folder / ('sub' if i % 2 else '') / 'c{}.png'.format(i))
        cv2.imwrite(p, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        paths.append(p)
    return dict(jengine=jengine, want=want, got=got,
                images=images, paths=paths, folder=str(folder))


def assert_outputs_match(got, want):
    emb, vis, masks = got[0], got[1], got[5]
    for k in want[0]:
        np.testing.assert_allclose(to_np(emb[k]), to_np(want[0][k]),
                                   atol=1e-4, rtol=1e-4, err_msg=k)
    for k in want[1]:
        np.testing.assert_array_equal(to_np(vis[k]), to_np(want[1][k]))
    np.testing.assert_allclose(to_nhwc(masks[PARTS]), to_np(want[5][PARTS]),
                               atol=1e-4)


def test_arrays_of_mixed_sizes_match_jax(rig):
    got = rig['got'](rig['images'])
    assert got[0]['bn_foreg'].shape == (len(SIZES), 32)
    assert_outputs_match(got, rig['want'](rig['images']))


def test_png_paths_match_jax(rig):
    assert_outputs_match(rig['got'](rig['paths']), rig['want'](rig['paths']))


def test_external_masks_match_jax(rig):
    rng = np.random.default_rng(1)
    batch = rng.integers(0, 256, (4, 64, 32, 3), dtype=np.uint8)
    masks = rng.uniform(size=(4, 16, 8, 36)).astype(np.float32)
    assert_outputs_match(rig['got'](batch, masks), rig['want'](batch, masks))
    assert_outputs_match(rig['got'](batch[0]), rig['want'](batch[0]))


def test_extract_reid_features_matches_jax(rig, tmp_path):
    jcfg, cfg = _configs()
    j_extract_reid_features(jcfg, rig['folder'], str(tmp_path / 'jax'),
                            engine=rig['jengine'])
    emb, vis, msk = extract_reid_features(
        cfg, rig['folder'], str(tmp_path / 'port'), model=rig['got'].model,
        device='cpu')
    assert emb.shape == (4, 6, 32) and vis.shape == (4, 6)
    files = sorted(os.listdir(tmp_path / 'jax'))
    assert files == sorted(os.listdir(tmp_path / 'port')) == [
        'embeddings_crops.npy', 'image_list_crops.txt',
        'parts_masks_crops.npy', 'visibility_scores_crops.npy']
    for name in files:
        a, b = (str(tmp_path / side / name) for side in ('jax', 'port'))
        if name.endswith('.txt'):
            assert open(a).read() == open(b).read()
            continue
        a, b = np.load(a), np.load(b)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4, err_msg=name)


def test_cli_inference_enabled_writes_the_features(rig, tmp_path):
    clear_dataset_cache()
    engine, _ = cli.main([
        '--config-file', SMOKE, '--save_dir', str(tmp_path), '--job-id', '1',
        '--inference-enabled', 'use_gpu', 'False', 'model.compute_dtype',
        'float32', 'test.evaluate', 'True', 'inference.input_folder',
        rig['folder']])
    out = tmp_path / '1'
    emb = np.load(out / 'embeddings_crops.npy')
    vis = np.load(out / 'visibility_scores_crops.npy')
    masks = np.load(out / 'parts_masks_crops.npy')
    assert emb.shape == (4, 6, 64) and vis.shape == (4, 6)
    assert masks.shape[0] == 4 and masks.shape[-1] == 5
    listed = open(out / 'image_list_crops.txt').read().split('\n')
    assert listed == sorted(rig['paths'])
    outputs = FeatureExtractor(engine.config, engine=engine)(listed)
    np.testing.assert_array_equal(emb[:, 0], to_np(outputs[0]['bn_foreg']))
    np.testing.assert_array_equal(emb[:, 1:], to_np(outputs[0]['parts']))


def test_entry_points_need_cuda_or_cpu_and_refuse_int8(rig, monkeypatch):
    cfg = _configs()[1]
    cfg.model.bpbreid.backbone = 'resnet18'
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        FeatureExtractor(cfg, model=rig['got'].model)
    cfg.test.int8 = True
    with pytest.raises(NotImplementedError, match='Queue 1 item 7'):
        FeatureExtractor(cfg, model=rig['got'].model, device='cpu')


def _chunk(kind, body):
    return (struct.pack('>I', len(body)) + kind + body
            + struct.pack('>I', zlib.crc32(kind + body)))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def write_png(path, img, row_filter):
    """A PNG of ``img`` ``[H, W, C]`` uint8 (C = 1, 3, 4) with every row
    filtered by ``row_filter`` (0-4), or by row index mod 5 for 'mixed'."""
    h, w, ch = img.shape
    x = img.reshape(h, w * ch).astype(np.int32)
    rows, zero = [], np.zeros(ch, np.int32)
    for y in range(h):
        up = x[y - 1] if y else np.zeros_like(x[y])
        left = np.concatenate([zero, x[y, :-ch]])
        up_left = np.concatenate([zero, up[:-ch]])
        f = y % 5 if row_filter == 'mixed' else row_filter
        pred = (0, left, up, (left + up) // 2, _paeth(left, up, up_left))[f]
        rows.append(bytes([f]) + ((x[y] - pred) % 256).astype(
            np.uint8).tobytes())
    header = struct.pack('>IIBBBBB', w, h, 8, {1: 0, 3: 2, 4: 6}[ch], 0, 0, 0)
    with open(path, 'wb') as f:
        f.write(b'\x89PNG\r\n\x1a\n' + _chunk(b'IHDR', header)
                + _chunk(b'IDAT', zlib.compress(b''.join(rows)))
                + _chunk(b'IEND', b''))


def _opencv_rgb(path):
    return cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)


@pytest.mark.parametrize('channels', [1, 3, 4])
def test_png_decoder_matches_opencv(channels, tmp_path):
    """Gray, RGB and RGBA at odd widths, written by OpenCV, by PIL and
    with each of the five row filters."""
    rng = np.random.default_rng(channels)
    for h, w in ((7, 5), (13, 1), (33, 17)):
        img = rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
        paths = []
        for f in (0, 1, 2, 3, 4, 'mixed'):
            paths.append(str(tmp_path / 'f{}_{}x{}.png'.format(f, h, w)))
            write_png(paths[-1], img, f)
        bgr = {1: img[..., 0], 3: img[..., ::-1], 4: img}[channels]
        paths.append(str(tmp_path / 'cv_{}x{}.png'.format(h, w)))
        cv2.imwrite(paths[-1], bgr)
        paths.append(str(tmp_path / 'pil_{}x{}.png'.format(h, w)))
        Image.fromarray(img[..., 0] if channels == 1 else img).save(paths[-1])
        for p in paths:
            got = read_image(p)
            assert got.dtype == np.uint8 and got.shape == (h, w, 3), p
            np.testing.assert_array_equal(got, _opencv_rgb(p), err_msg=p)


def test_other_formats_go_through_pil(tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (9, 7, 3), dtype=np.uint8)
    jpeg, deep = str(tmp_path / 'a.jpg'), str(tmp_path / 'deep.png')
    Image.fromarray(img).save(jpeg)
    cv2.imwrite(deep, img.astype(np.uint16) * 257)
    with Image.open(jpeg) as im:
        np.testing.assert_array_equal(read_image(jpeg),
                                      np.asarray(im.convert('RGB')))
    monkeypatch.setitem(sys.modules, 'PIL', None)
    with pytest.raises(ImportError, match='JPEG'):
        read_image(jpeg)
    with pytest.raises(ImportError, match='bit depth 16'):
        read_image(deep)
