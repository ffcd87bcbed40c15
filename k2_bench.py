#!/usr/bin/env python3
"""Times K2 (``fused_attention_pool``, ``ops/cuda/attention_pool.cu``) on
one NVIDIA GPU at the shapes the models feed it.

    python3 k2_bench.py [--repo DIR] [--label NAME]

Shapes ``[N, D, H, W]`` with K+1 = 6 (five_v), logits bf16 as on the
path: HRNet-W32's map at 384x128 in f32 and in bf16 (the dtype every
model hands it), the fastreid ResNet-IBN-NL map and NASNet's; then
HRNet-W32's map at bf16 with K+1 = 3, 12, 15 and 37, the part counts
that take the padded instantiations (4, 16, 16 and 64 accumulators a
channel: the 'two', 'eleven', 'fourteen' and PifPaf 'full' masks
with their background). For each,
``chip_smoke.k2_row``: the check against ``attention_pool_reference``
(2e-5 of the largest output), the eager ms of the kernel, the plain
version and the library call (``chip_smoke.attention_pool_library``:
softmax, bmm, sum, amax), each CUDA events around 10 calls, median of 5;
the device ms of the kernel and of the library call (a CUDA graph of 20
calls); the byte bound. ``--repo DIR`` imports ``bpbreid_tpu_torch`` from
another checkout (the parent of a change, unpacked under ``_scratch/``),
so two versions are compared in one call: parent, change, change, parent.
Prints one JSON line a shape and appends them to
``chiprun_out/k2_bench[_<label>].json``. Needs one CUDA card; exits 1
without one.
"""
import argparse
import json
import os
import sys

import chip_smoke

# (N, D, H, W, K+1, feature dtype name)
SHAPES = [(64, 1920, 96, 32, 6, 'float32'),
          (64, 1920, 96, 32, 6, 'bfloat16'),
          (64, 2048, 24, 8, 6, 'bfloat16'),
          (64, 1056, 12, 4, 6, 'bfloat16'),
          (64, 1920, 96, 32, 3, 'bfloat16'),
          (64, 1920, 96, 32, 12, 'bfloat16'),
          (64, 1920, 96, 32, 15, 'bfloat16'),
          (64, 1920, 96, 32, 37, 'bfloat16')]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--repo', default=None,
                    help='import bpbreid_tpu_torch from this checkout')
    ap.add_argument('--label', default=None)
    args = ap.parse_args()
    if args.repo:
        for name in [m for m in sys.modules
                     if m.split('.')[0] == 'bpbreid_tpu_torch']:
            del sys.modules[name]
        sys.path.insert(0, os.path.abspath(args.repo))
    import torch
    if not torch.cuda.is_available():
        print('k2_bench: CUDA is not available', file=sys.stderr)
        return 1
    import bpbreid_tpu_torch
    from bpbreid_tpu_torch.ops.cuda.build import build_kernels
    logs = build_kernels(['attention_pool'])
    os.makedirs('chiprun_out', exist_ok=True)
    suffix = '_' + args.label if args.label else ''
    for log in logs.values():     # ptxas: registers and spills
        with open(os.path.join('chiprun_out',
                               'k2_bench_ptxas{}.log'.format(suffix)),
                  'w') as f:
            f.write(log)
    gpu = chip_smoke.gpu_name_and_power_limit()
    label = args.label or os.path.dirname(bpbreid_tpu_torch.__file__)
    gen = torch.Generator(device='cuda').manual_seed(chip_smoke.SEED)
    rows, failures = [], []
    for n, d, h, w, k1, dt in SHAPES:
        feats = torch.randn(n, d, h, w, device='cuda',
                            generator=gen).to(getattr(torch, dt))
        logits = (3 * torch.randn(n, k1, h, w, device='cuda',
                                  generator=gen)).to(torch.bfloat16)
        row, failed = chip_smoke.k2_row(torch, feats, logits)
        row.update(label=label, gpu=gpu)
        failures += failed
        print(json.dumps(row), flush=True)
        rows.append(row)
        del feats, logits
    name = 'k2_bench{}.json'.format(suffix)
    with open(os.path.join('chiprun_out', name), 'a') as f:
        for row in rows:
            f.write(json.dumps(row) + '\n')
    if failures:
        print('\n'.join(failures), file=sys.stderr)
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
