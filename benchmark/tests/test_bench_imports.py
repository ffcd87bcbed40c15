"""What the benchmark loads: no module whose top-level name (the part
before the first dot, compared whole) is ``jax``, ``jaxlib``, ``flax`` or
``bpbreid_tpu`` in a run, and none of those nor ``bpbreid_tpu_torch`` in
the reference. A run without a CUDA device, or without the program
beside the benchmark, exits non-zero and prints no result."""
import json
import os
import shutil
import subprocess
import sys

from benchmark import core
from benchmark.tests.tiny import tiny_root

FORBIDDEN = {'jax', 'jaxlib', 'flax', 'bpbreid_tpu'}


def _python(code, cwd=core.ROOT, pythonpath=None):
    env = dict(os.environ)
    env.pop('PYTHONPATH', None)
    if pythonpath:
        env['PYTHONPATH'] = pythonpath
    return subprocess.run([sys.executable, '-c', code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def _top_level(stdout):
    return set(json.loads(stdout.strip().splitlines()[-1]))


def _references():
    """Every module under ``benchmark/reference/``, by listing it."""
    folder = os.path.join(core.ROOT, 'benchmark', 'reference')
    return sorted(f[:-3] for f in os.listdir(folder)
                  if f.endswith('.py') and f != '__init__.py')


def test_reference_loads_no_program_and_no_jax():
    modules = _references()
    assert {'layers', 'model', 'train', 'masks'} <= set(modules)
    out = _python(
        'import importlib, sys, json; sys.path.insert(0, {!r})\n'
        'import benchmark.reference\n'
        'for name in {!r}:\n'
        '    importlib.import_module("benchmark.reference." + name)\n'
        'from benchmark.core import load_benchmark\n'
        'for c in load_benchmark()["configs"]:\n'
        '    benchmark.reference.reference_of(json.load(open(c["file"])))\n'
        'print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))'
        .format(core.ROOT, modules))
    assert out.returncode == 0, out.stderr
    names = _top_level(out.stdout)
    assert 'benchmark' in names
    assert not names & (FORBIDDEN | {'bpbreid_tpu_torch'})


def test_a_run_loads_no_jax(tmp_path):
    root = tiny_root(tmp_path)
    out = _python(
        'import sys, json; sys.path.insert(0, {root!r})\n'
        'import torch; torch.set_num_threads(2)\n'
        'from benchmark import core\n'
        'for kind in ("train", "embed"):\n'
        '    cell = core.Cell(core.load_benchmark({root!r}), kind + ".tiny",'
        ' {root!r})\n'
        '    core.run_cell(cell, 5, 0.3, 1, "cpu")\n'
        'print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))'
        .format(root=root), pythonpath=core.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    names = _top_level(out.stdout)
    assert 'bpbreid_tpu_torch' in names
    assert not names & FORBIDDEN
    assert core.forbidden_modules({'jax.numpy': 1, 'bpbreid_tpu_torch': 1,
                                   'bpbreid_tpu.models': 1}) == [
        'bpbreid_tpu.models', 'jax.numpy']


def test_no_cuda_no_result():
    out = subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload',
         'train.bpbreid_hrnet32', '--seed', '3000000019', '--seconds', '1',
         '--trace', '0'], cwd=core.ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, 'CUDA_VISIBLE_DEVICES': ''})
    assert out.returncode != 0
    assert out.stdout.strip() == ''


def test_without_the_program_no_result(tmp_path):
    bare = tmp_path / 'bare'
    bare.mkdir()
    shutil.copy(os.path.join(core.ROOT, 'BENCHMARK.json'), bare)
    root = tiny_root(tmp_path / 'tiny')
    shutil.copytree(os.path.join(root, 'benchmark'), bare / 'benchmark')
    shutil.copy(os.path.join(root, 'BENCHMARK.json'), bare)
    # the sandbox may install the repo's packages; hide the program as a
    # checkout without it lacks it
    out = _python(
        'import sys; sys.path.insert(0, {bare!r})\n'
        'sys.modules["bpbreid_tpu_torch"] = None\n'
        'from benchmark import core\n'
        'cell = core.Cell(core.load_benchmark({bare!r}), "train.tiny", '
        '{bare!r})\n'
        'print(core.run_cell(cell, 5, 0.3, 0, "cpu"))'.format(bare=str(bare)),
        cwd=str(bare))
    assert out.returncode != 0
    assert 'bpbreid_tpu_torch' in out.stderr
    assert out.stdout.strip() == ''
