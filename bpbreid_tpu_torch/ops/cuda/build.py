"""Build and load the port's CUDA kernels.

Each ``<source>.cu`` in this directory exposes a plain C interface (one
or more entry points; ``KERNELS`` names them). At
first use it is compiled with ``nvcc`` for ``sm_90a`` into a shared
library under ``bpbreid_tpu_torch/_build/`` (keyed by a hash of the
source and flags) and loaded with ``ctypes``. Nothing here imports or
links PyTorch's headers, so a build takes seconds. A failed build
raises; nothing falls back to a plain version.

``launch_counts`` counts kernel launches by name: each wrapper adds one
where it launches its kernel, so a run can show that its path went
through the kernels.
"""
import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ['KERNELS', 'build_kernels', 'load_kernel', 'launch_counts',
           'reset_launch_counts', 'check_cuda_error', 'library_path']

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parents[1] / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-O3',
              '-std=c++17', '-shared', '-Xcompiler', '-fPIC',
              '-Xptxas', '-v')

# kernel name -> (source, C function, ctypes argtypes)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNELS = {
    'attention_pool': ('attention_pool', 'bpbreid_attention_pool',
                       [_P] * 5 + [_I] * 11 + [_P]),
    'bn_stats': ('bn_stats', 'bpbreid_bn_stats',
                 [_P] * 6 + [_I] * 4 + [_F, _I, _P]),
    'bn_apply': ('bn_stats', 'bpbreid_bn_apply', [_P] * 6 + [_I] * 6 + [_P]),
    'bn_apply_sums': ('bn_stats', 'bpbreid_bn_apply_sums',
                      [_P] * 8 + [_I] * 5 + [_F, _I, _I, _P]),
    'bn_grad_stats': ('bn_stats', 'bpbreid_bn_grad_stats',
                      [_P] * 6 + [_I] * 6 + [_P]),
    'bn_dx': ('bn_stats', 'bpbreid_bn_dx', [_P] * 8 + [_I] * 7 + [_P]),
    'conv_chain': ('conv_chain', 'bpbreid_conv_chain',
                   [_P] * 7 + [_I] * 9 + [_P]),
    'conv_chain_bf16': ('conv_chain', 'bpbreid_conv_chain_bf16',
                        [_P] * 9 + [_I] * 10 + [_P]),
    'conv_s8': ('conv_s8', 'bpbreid_conv_s8', [_P] * 5 + [_I] * 28 + [_P]),
    'quantize_s8': ('conv_s8', 'bpbreid_quantize_s8',
                    [_P, _P, _I, _P] + [_I] * 6 + [_P]),
}

launch_counts = collections.Counter()
_libs, _fns = {}, {}
_lock = threading.Lock()


def reset_launch_counts():
    launch_counts.clear()


def _nvcc():
    nvcc = shutil.which('nvcc')
    if nvcc is None and os.path.exists('/usr/local/cuda/bin/nvcc'):
        nvcc = '/usr/local/cuda/bin/nvcc'
    if nvcc is None:
        raise RuntimeError('nvcc not found: the CUDA kernels of '
                           'bpbreid_tpu_torch cannot be built')
    return nvcc


def _library_path(source):
    src = SRC_DIR / '{}.cu'.format(source)
    digest = hashlib.sha256(src.read_bytes()
                            + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / 'lib{}-{}.so'.format(source, digest)


def library_path(source):
    """Path of the shared library built from ``<source>.cu``."""
    return _library_path(source)[1]


def build_kernels(names=None):
    """Compile the sources of the named kernels that are not built yet,
    one ``nvcc`` per source, all started together. Returns ``{source:
    ptxas log}`` for the sources compiled by this call; raises on any
    failed build."""
    names = list(KERNELS if names is None else names)
    sources = sorted({KERNELS[name][0] for name in names})
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in sources:
        src, out = _library_path(name)
        if out.exists():
            continue
        tmp = out.with_name('{}.{}.tmp'.format(out.name, os.getpid()))
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append('{} (exit {}):\n{}'.format(name, proc.returncode,
                                                     log))
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError('CUDA kernel build failed: ' + '\n'.join(failed))
    return logs


def load_kernel(name):
    """``(library, ctypes function)`` of kernel ``name``, building its
    source at first use."""
    with _lock:
        if name not in _fns:
            source, fn_name, argtypes = KERNELS[name]
            if source not in _libs:
                _, out = _library_path(source)
                if not out.exists():
                    build_kernels([name])
                lib = ctypes.CDLL(str(out))
                lib.bpbreid_cuda_error_string.argtypes = [ctypes.c_int]
                lib.bpbreid_cuda_error_string.restype = ctypes.c_char_p
                _libs[source] = lib
            lib = _libs[source]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _fns[name] = (lib, fn)
        return _fns[name]


def check_cuda_error(lib, code, what):
    if code != 0:
        raise RuntimeError('{} failed: CUDA error {} ({})'.format(
            what, code, lib.bpbreid_cuda_error_string(code).decode()))
