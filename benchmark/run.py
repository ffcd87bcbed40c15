#!/usr/bin/env python3
"""Run one cell of the benchmark of bpbreid_tpu_torch once and print its
result line (the last line of standard output, one JSON object).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run it from the root of a checkout. It needs as many CUDA devices as the
cell asks for and exits non-zero, printing no result, without them. The
caches of the program (its CUDA kernel builds under
``bpbreid_tpu_torch/_build/``, and any Triton, extension or CUDA JIT
cache) stay inside the checkout."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, 'benchmark', '_cache')
for _var, _sub in (('TRITON_CACHE_DIR', 'triton'),
                   ('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                   ('TORCHINDUCTOR_CACHE_DIR', 'inductor'),
                   ('CUDA_CACHE_PATH', 'cuda')):
    os.environ[_var] = os.path.join(CACHE, _sub)
sys.path.insert(0, ROOT)

if __name__ == '__main__':
    from benchmark import core
    sys.exit(core.main(sys.argv[1:]))
