"""Package-level checks of bpbreid_tpu_torch: it imports no JAX, its
entry points raise without CUDA unless the caller asks for the CPU, its
weights are seeded, and chip_smoke.py fails where there is no card."""
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import bpbreid_tpu_torch
from bpbreid_tpu_torch.config import get_default_config
from bpbreid_tpu_torch.engine.part_based import ImagePartBasedEngine
from bpbreid_tpu_torch.models import build_model
from tests.torch_port_helpers import SMALL_W32, limit_torch_threads

limit_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_entry_points_raise_without_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    cfg = get_default_config()
    cfg.model.bpbreid.backbone = 'hrnet32'
    with pytest.raises(RuntimeError, match='CUDA'):
        build_model('hrnet32', 1, stages=SMALL_W32)
    with pytest.raises(RuntimeError, match='CUDA'):
        ImagePartBasedEngine(torch.nn.Identity())
    with pytest.raises(RuntimeError, match='CUDA'):
        bpbreid_tpu_torch.resolve_device('cuda')
    model = build_model('hrnet32', 1, device='cpu', stages=SMALL_W32)
    assert next(model.parameters()).device.type == 'cpu'
    assert not model.training
    # every name of JAX's registry builds; a name outside it raises
    with pytest.raises(NotImplementedError, match='not in the registry'):
        build_model('senet155', 1, device='cpu')
    with pytest.raises(RuntimeError, match='CUDA'):
        build_model('squeezenet1_1', 1)
    assert not build_model('squeezenet1_1', 1, device='cpu').training


def test_build_model_is_seeded():
    a = build_model('hrnet32', 1, device='cpu', seed=3, stages=SMALL_W32)
    b = build_model('hrnet32', 1, device='cpu', seed=3, stages=SMALL_W32)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k


def test_port_imports_no_jax():
    """In a fresh interpreter (tests/conftest.py imports jax here)."""
    names = ['bpbreid_tpu_torch'] + [
        m.name for m in pkgutil.walk_packages(bpbreid_tpu_torch.__path__,
                                              'bpbreid_tpu_torch.')]
    code = ('import importlib, sys\n'
            'for n in {!r}: importlib.import_module(n)\n'
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "flax", "bpbreid_tpu")]\n'
            'print("BAD", bad)\n'
            'sys.exit(1 if bad else 0)\n').format(names)
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert len(names) > 15
    assert {'bpbreid_tpu_torch.tools.feature_extractor',
            'bpbreid_tpu_torch.tools.extract_part_based_features',
            'bpbreid_tpu_torch.utils.torch_weights',
            'bpbreid_tpu_torch.utils.rerank',
            'bpbreid_tpu_torch.metrics.accuracy',
            'bpbreid_tpu_torch.utils.visualization.imaging',
            'bpbreid_tpu_torch.utils.visualization.rankings',
            'bpbreid_tpu_torch.ops.quant',
            'bpbreid_tpu_torch.ops.cuda.conv_s8',
            'bpbreid_tpu_torch.utils.tools',
            'bpbreid_tpu_torch.data.data_augmentation.random_occlusion',
            'bpbreid_tpu_torch.data.datasets.small_datasets',
            'bpbreid_tpu_torch.data.datasets.video_datasets',
            'bpbreid_tpu_torch.data.video',
            'bpbreid_tpu_torch.engine.video.softmax',
            'bpbreid_tpu_torch.engine.video.triplet',
            'bpbreid_tpu_torch.models.zoo', 'bpbreid_tpu_torch.models.pcb',
            'bpbreid_tpu_torch.models.pvpm', 'bpbreid_tpu_torch.models.senet',
            'bpbreid_tpu_torch.models.densenet',
            'bpbreid_tpu_torch.models.mobilenetv2',
            'bpbreid_tpu_torch.models.shufflenet',
            'bpbreid_tpu_torch.models.shufflenetv2',
            'bpbreid_tpu_torch.models.squeezenet',
            'bpbreid_tpu_torch.models.mlfn',
            'bpbreid_tpu_torch.models.xception',
            'bpbreid_tpu_torch.models.inceptionv4',
            'bpbreid_tpu_torch.models.inceptionresnetv2',
            'bpbreid_tpu_torch.models.nasnet',
            'bpbreid_tpu_torch.models.mudeep',
            'bpbreid_tpu_torch.models.hacnn',
            'bpbreid_tpu_torch.ops.grid_sample',
            'bpbreid_tpu_torch.ops.compact_bilinear_pooling'} <= set(names)


def test_port_imports_no_cv2_or_pil():
    """Every module of the port, its CLI and chip_smoke.py load no
    OpenCV, no PIL, no matplotlib and no h5py (the card's machine has
    none of them; the ranking grids draw without them); images are
    decoded with PIL only when a file is read, h5py only for CUHK03's raw
    extraction. Fresh interpreter."""
    names = ['bpbreid_tpu_torch', 'bpbreid_tpu_torch.scripts.main'] + [
        m.name for m in pkgutil.walk_packages(bpbreid_tpu_torch.__path__,
                                              'bpbreid_tpu_torch.')]
    code = ('import importlib, importlib.util, sys\n'
            'for n in {!r}: importlib.import_module(n)\n'
            'spec = importlib.util.spec_from_file_location('
            '"chip_smoke", "chip_smoke.py")\n'
            'spec.loader.exec_module(importlib.util.module_from_spec(spec))\n'
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("cv2", "PIL", "matplotlib", "h5py", "jax", "flax", '
            '"bpbreid_tpu")]\n'
            'print("BAD", bad)\n'
            'sys.exit(1 if bad else 0)\n').format(names)
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'bpbreid_tpu_torch.data.datasets.dataset' in names


def test_port_sources_name_no_jax():
    roots = [os.path.join(REPO, 'bpbreid_tpu_torch'),
             os.path.join(REPO, 'chip_smoke.py'),
             os.path.join(REPO, 'k1_bench.py'),
             os.path.join(REPO, 'rerank_bench.py')]
    files = roots[1:] + [os.path.join(d, f)
                          for d, _, fs in os.walk(roots[0]) for f in fs
                          if f.endswith('.py')]
    for path in files:
        with open(path) as f:
            for line in f:
                s = line.strip()
                if s.startswith(('import ', 'from ')):
                    mod = s.split()[1].split('.')[0]
                    assert mod not in ('jax', 'jaxlib', 'flax',
                                       'bpbreid_tpu'), (path, s)


def test_chip_smoke_fails_without_cuda(tmp_path):
    """No CUDA here: the smoke exits non-zero and prints no result, in
    the checkout and alone in a directory."""
    script = os.path.join(REPO, 'chip_smoke.py')
    alone = tmp_path / 'chip_smoke.py'
    alone.write_bytes(open(script, 'rb').read())
    for cwd, path in ((REPO, script), (str(tmp_path), str(alone))):
        proc = subprocess.run([sys.executable, path], cwd=cwd,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def test_k1_bench_fails_without_cuda():
    proc = subprocess.run([sys.executable, 'k1_bench.py'], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1 and proc.stdout == ''
    assert 'CUDA is not available' in proc.stderr


def test_rerank_bench_fails_without_cuda():
    proc = subprocess.run([sys.executable, 'rerank_bench.py'], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1 and proc.stdout == ''
    assert 'CUDA is not available' in proc.stderr
