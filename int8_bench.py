#!/usr/bin/env python3
"""Per-shape times of the port's int8 kernels (``conv_s8``,
``quantize_s8``) on one NVIDIA GPU, at the call shapes of the int8
serving step: HRNet-W32 BPBReID at 384x128, batch 64, bf16, JAX's
default int8 graph (the shapes and their launches a step:
``ops/cuda/conv_s8.py SERVING_STEP_CONVS`` and ``SERVING_STEP_QUANTS``).

    python3 int8_bench.py [--repo DIR] [--label NAME] [--box-rows]

Each row (``chip_smoke.py _int8_shape_table``): launches a step, the
kernel's device ms (a CUDA graph of 20 calls, no host time between
launches; ``quantize_s8`` on a ReLU's output and on N(0, 1) values) and
its ms over back-to-back eager calls (CUDA events, the host's launch
cost included), its bound, cuDNN's bf16 ``F.conv2d``
device ms at the same shape and, for a 1x1 stride-1 conv,
``torch._int_mm``'s on the ``[N*H*W, Cin] x [Cin, Co]`` view; then the
sums launches x ms a step. ``--repo DIR`` imports ``bpbreid_tpu_torch``
from another checkout (for example the parent commit, unpacked with
``git archive`` into a gitignored directory) and builds its kernels
there: run parent, change, change, parent in one call to compare two
versions on one card (the shapes are this checkout's).
``--box-rows`` adds, at each step conv whose A box rows can be grouped
into 128-byte units, the plan with and without them
(``box_row_table``). Prints the card's name and power limit and, last,
one JSON line; needs a CUDA card.
"""
import argparse
import json
import os
import sys
import time

import chip_smoke


def box_row_table(torch):
    """At each step conv whose A box rows can be grouped into 128-byte
    units (``rows_groupable``: all ``Cp <= 64`` channels in one chunk),
    the planner's plan with grouped rows (a 128-byte swizzle) and with
    one pixel's ``Cp`` channels a box row (a ``Cp``-byte swizzle, 32 or
    64): both bit-equal to the plain version, and their device ms
    (``graph_ms``) and device ms with inputs out of L2."""
    from bpbreid_tpu_torch.ops.cuda.conv_s8 import (
        SERVING_STEP_CONVS, check_conv_plan, conv_s8, conv_s8_reference,
        plan_conv_tiles, rows_groupable)
    gen = torch.Generator(device='cuda').manual_seed(chip_smoke.SEED + 2)
    rows = []
    for key, launches in sorted(SERVING_STEP_CONVS.items()):
        n, cin, h, w, co, k, stride, pad = key
        xq, wp, sw, _ = chip_smoke._s8_conv_case(torch, gen, key[:7])
        cp = xq.shape[-1]
        planned = plan_conv_tiles(n, h, w, cp, co, k, stride, pad)
        if not (planned.kc == cp and rows_groupable(cp, cp, w)):
            continue
        want = conv_s8_reference(xq, wp, sw, None, k, stride, pad, cin)
        row = {'shape': list(key[:7]), 'launches': launches,
               'planned_grouped': planned.grouped}
        copies = [xq.clone() for _ in range(chip_smoke.cold_copies(
            xq.nbytes))]
        for name, plan in (('rows_128', planned._replace(grouped=True)),
                           ('rows_cp', planned._replace(grouped=False))):
            layout = check_conv_plan(plan, k, stride, pad, cp, w)

            def call(x=xq, plan=plan):
                return conv_s8(x, wp, sw, None, k, stride, pad, cin,
                               plan=plan)
            if not torch.equal(call(), want):
                raise AssertionError('conv_s8 {} with {} differs from its '
                                     'plain version'.format(key, name))
            row[name] = {
                'plan': list(plan), 'box': [layout.box_inner,
                                            layout.box_cols,
                                            layout.box_rows],
                'smem': layout.smem,
                'device_ms': chip_smoke.graph_ms(torch, call),
                'cold_ms': chip_smoke.graph_ms(
                    torch, [lambda x=x, c=call: c(x) for x in copies])}
        rows.append(row)
        print('box rows {} x{}: 128-byte rows {:.4f} ms ({:.4f} out of '
              'L2), {}-byte rows {:.4f} ms ({:.4f} out of L2); planned {}'
              .format(key[:7], launches, row['rows_128']['device_ms'],
                      row['rows_128']['cold_ms'], cp,
                      row['rows_cp']['device_ms'], row['rows_cp']['cold_ms'],
                      '128' if planned.grouped else cp), flush=True)
        del xq, copies, want
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--repo', default=None,
                    help='import bpbreid_tpu_torch from this checkout')
    ap.add_argument('--label', default=None)
    ap.add_argument('--box-rows', action='store_true',
                    help='also time A\'s box rows of 128 bytes against '
                         'rows of one pixel\'s channels')
    args = ap.parse_args()
    # the step's calls are this checkout's; the kernels --repo's
    conv_calls, quant_calls = chip_smoke.serving_step_int8_calls()
    if args.repo:
        for name in [m for m in sys.modules
                     if m.split('.')[0] == 'bpbreid_tpu_torch']:
            del sys.modules[name]
        sys.path.insert(0, os.path.abspath(args.repo))
    import torch
    if not torch.cuda.is_available():
        print('int8_bench: CUDA is not available', file=sys.stderr)
        return 1
    import bpbreid_tpu_torch
    from bpbreid_tpu_torch.ops.cuda.build import build_kernels
    t0 = time.perf_counter()
    build_kernels(['conv_s8'])
    build_s = time.perf_counter() - t0
    gpu = chip_smoke.gpu_name_and_power_limit()
    print(gpu, flush=True)
    table = chip_smoke._int8_shape_table(torch, conv_calls, quant_calls)
    out = {'label': args.label or os.path.abspath(
               os.path.dirname(bpbreid_tpu_torch.__file__)),
           'gpu': gpu, 'torch': torch.__version__, 'build_s': build_s,
           **table}
    if args.box_rows:
        out['box_rows'] = box_row_table(torch)
    os.makedirs('chiprun_out', exist_ok=True)
    name = 'int8_bench{}.json'.format(
        '_' + args.label if args.label else '')
    with open(os.path.join('chiprun_out', name), 'a') as f:
        f.write(json.dumps(out) + '\n')
    print(json.dumps({k: out[k] for k in (
        'label', 'gpu', 'conv_s8_sums', 'quantize_s8_sums')}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
