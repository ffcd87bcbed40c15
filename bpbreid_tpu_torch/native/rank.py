"""ctypes wrapper of the native C++ ranker (``rank.cpp``; port of
bpbreid_tpu/native/rank.py).

At first use ``rank.cpp`` is compiled with ``g++ -O3 -std=c++17 -shared
-fPIC -pthread`` into ``bpbreid_tpu_torch/_build/librank-<hash>.so``,
keyed by a hash of the source and the flags (as ``ops/cuda/build.py``
keys the CUDA sources), and loaded with ``ctypes``. A failed build
raises with the compiler's output: nothing falls back to the numpy
ranker (``metrics/rank.py`` takes that path only when asked,
``use_native=False``). The analogue of the reference's Cython module
(torchreid/metrics/rank_cylib/), with a multithreaded single-pass
CMC + AP accumulation.
"""
import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ['eval_market1501', 'eval_cuhk03', 'load', 'library_path']

SRC = Path(__file__).resolve().parent / 'rank.cpp'
BUILD_DIR = Path(__file__).resolve().parents[1] / '_build'
CXX = 'g++'
CXX_FLAGS = ('-O3', '-std=c++17', '-shared', '-fPIC', '-pthread')

_I64P = ctypes.POINTER(ctypes.c_int64)
_COMMON = [ctypes.POINTER(ctypes.c_float), _I64P, _I64P, _I64P, _I64P,
           ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
_ARGTYPES = {
    'eval_market1501': _COMMON + [ctypes.POINTER(ctypes.c_float),
                                  ctypes.POINTER(ctypes.c_double),
                                  ctypes.c_int64],
    'eval_cuhk03': _COMMON + [ctypes.c_int64, ctypes.c_uint64,
                              ctypes.POINTER(ctypes.c_float),
                              ctypes.POINTER(ctypes.c_double),
                              ctypes.c_int64],
}
_libs = {}
_lock = threading.Lock()


def library_path():
    """Path of the shared library built from this ``rank.cpp``."""
    digest = hashlib.sha256(SRC.read_bytes() + ' '.join(
        (CXX,) + CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / 'librank-{}.so'.format(digest)


def _build(out):
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name('{}.{}.tmp'.format(out.name, os.getpid()))
    cmd = [CXX, *CXX_FLAGS, str(SRC), '-o', str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError('native ranker build failed: cannot run {!r} '
                           '({})'.format(CXX, e)) from e
    if proc.returncode != 0:
        raise RuntimeError('native ranker build failed (exit {}): {}\n{}'
                           .format(proc.returncode, ' '.join(cmd),
                                   proc.stderr + proc.stdout))
    os.replace(tmp, out)


def load():
    """The loaded library, built at first use; raises if the build
    fails."""
    out = library_path()
    with _lock:
        if out not in _libs:
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
            for name, argtypes in _ARGTYPES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[out] = lib
        return _libs[out]


def _operands(distmat, q_pids, g_pids, q_camids, g_camids):
    distmat = np.ascontiguousarray(distmat, dtype=np.float32)
    if distmat.ndim != 2:
        raise ValueError('distmat must be [Nq, Ng], got {}'.format(
            distmat.shape))
    ids = [np.ascontiguousarray(a, dtype=np.int64)
           for a in (q_pids, g_pids, q_camids, g_camids)]
    num_q, num_g = distmat.shape
    if [len(a) for a in ids] != [num_q, num_g, num_q, num_g]:
        raise ValueError('ids of lengths {} do not fit distmat {}'.format(
            [len(a) for a in ids], distmat.shape))
    return distmat, ids


def _run(name, distmat, ids, max_rank, extra, num_threads):
    """Call ``name`` on validated operands; the arrays stay referenced
    here while the native code reads them."""
    num_q, num_g = distmat.shape
    max_rank = min(max_rank, num_g)
    cmc = np.zeros(max_rank, dtype=np.float32)
    mAP = ctypes.c_double(0.0)
    ptrs = [distmat.ctypes.data_as(ctypes.POINTER(ctypes.c_float))] + [
        a.ctypes.data_as(_I64P) for a in ids]
    ret = getattr(load(), name)(
        *ptrs, num_q, num_g, max_rank, *extra,
        cmc.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.byref(mAP), int(num_threads))
    if ret != 0:
        raise RuntimeError(
            'Error: all query identities do not appear in gallery')
    return {'cmc': cmc, 'mAP': float(mAP.value)}


def eval_market1501(distmat, q_pids, g_pids, q_camids, g_camids, max_rank,
                    num_threads=0):
    """``metrics.rank.eval_market1501`` in C++ (``num_threads`` 0: one
    thread per hardware thread). Ties keep gallery index order (a stable
    sort), as the numpy path does."""
    distmat, ids = _operands(distmat, q_pids, g_pids, q_camids, g_camids)
    return _run('eval_market1501', distmat, ids, max_rank, (), num_threads)


def eval_cuhk03(distmat, q_pids, g_pids, q_camids, g_camids, max_rank,
                num_repeats=10, seed=0, num_threads=0):
    """The CUHK03 single-gallery-shot protocol in C++.

    Deterministic for a given ``seed`` at any thread count (a
    counter-based RNG for each (query, repeat, group)): the same stream
    as the JAX package's native ranker, so its CMC is that ranker's to
    the bit. The stream differs from the numpy path's, whose CMC agrees
    only in distribution; mAP is exact in both."""
    distmat, ids = _operands(distmat, q_pids, g_pids, q_camids, g_camids)
    return _run('eval_cuhk03', distmat, ids, max_rank,
                (int(num_repeats), int(seed)), num_threads)
