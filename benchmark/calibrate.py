#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the chip at the
cell's own size; the benchmark's own runs never run this.

    python3 benchmark/calibrate.py --workload <cell> --seeds <n> \
        [--controls <m>] [--first-seed <s>] [--seconds <w>]

For each of ``n`` seeds it runs the cell's set-up as a run does (and, for
the ``embed`` kind, a window of ``w`` seconds) and prints every candidate
number of the comparison between the program and the plain reference
(``sound``). For the first ``m`` seeds it also prints the same numbers
for:

- ``control``: the lower precision below the configuration's bf16. For
  ``train`` the reference with float8 products in the program's place
  (``TRAIN_CONTROL``); for ``embed`` the program's own
  int8 path (``test.int8``: calibrated int8 convolutions), and the float8
  reference beside it (``control_fp8``);
- ``train`` faults, planted in the reference put in the program's place:
  ``fault_half_batch`` (half of each batch left out, the mean over the
  rest); a state left unchanged reads 1 on the parameter-change numbers
  and needs no run.

One JSON line per reading on standard output, also appended to
``chiprun_out/calibrate_<cell>.jsonl``.
"""
import argparse
import copy
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# the train control's precision: float8 (e4m3 operands, e5m2 output
# gradients, per-tensor scales); int8 separated less from the program's
# bf16 on the identity heads' gradients (see PERF.md)
TRAIN_CONTROL = 'fp8'


def _emit(cell, row):
    line = json.dumps(row)
    print(line, flush=True)
    os.makedirs(os.path.join(ROOT, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(ROOT, 'chiprun_out',
                           'calibrate_{}.jsonl'.format(cell)), 'a') as f:
        f.write(line + '\n')


def _free():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def train_readings(ctx_for, seed, controls):
    tr = ctx_for(seed)
    t0 = time.perf_counter()
    tr.setup()
    setup_s = time.perf_counter() - t0
    tr.release()
    ref = tr.reference('f32')
    rows = [('sound', tr.readings(tr.program_readings(), ref),
             {'setup_s': setup_s, 'losses': tr.prog_losses,
              'ref_losses': ref['losses'],
              'worst_leaves': dict(tr.worst_leaves)})]
    if controls:
        low = tr.reference(TRAIN_CONTROL)
        rows.append(('control', tr.readings(low, ref),
                     {'losses': low['losses'], 'precision': TRAIN_CONTROL}))
        n = int(tr.pool[0]['pid'].shape[1])
        half = tr.reference('f32', rows=n // 2)
        rows.append(('fault_half_batch', tr.readings(half, ref),
                     {'losses': half['losses']}))
    del tr
    _free()
    return rows


def embed_readings(ctx_for, seed, controls, seconds):
    from benchmark.port import build_engine
    tr = ctx_for(seed)
    tr.setup()
    tr.window(seconds)
    picked = [tr.outputs[i] for i in tr.sample()]
    requests = [r for r, _, _ in picked]
    tr.release()
    ref = tr.reference(requests)
    rows = [('sound', tr.readings([(f, v) for _, f, v in picked], ref), {})]
    if controls:
        workload = copy.deepcopy(tr.workload)
        workload.setdefault('port', {}).setdefault('test', {})['int8'] = True
        weights = {k: v.to(tr.ctx.device) for k, v in tr.host_weights.items()}
        tr.engine, tr.model = build_engine(tr.config, workload,
                                           tr.ctx.seed + 2, weights,
                                           tr.ctx.device, train=False)
        del weights
        int8 = [tr._request(r) for r in requests]
        tr.release()
        rows.append(('control', tr.readings(int8, ref), {'path': 'int8'}))
        rows.append(('control_fp8', tr.readings(
            tr.reference(requests, 'fp8'), ref), {}))
    del tr
    _free()
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, default=12)
    ap.add_argument('--controls', type=int, default=3)
    ap.add_argument('--first-seed', type=int, default=3_000_000_001)
    ap.add_argument('--seconds', type=float, default=2.0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print('calibrate: CUDA is not available', file=sys.stderr)
        return 2
    from benchmark import core
    cell = core.find_cell(args.workload)
    traffic = core.load_traffic(cell.kind)

    def ctx_for(seed):
        return traffic.Traffic(core.Context(cell, seed, 'cuda:0'))

    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        t0 = time.perf_counter()
        if cell.kind == 'train':
            rows = train_readings(ctx_for, seed, i < args.controls)
        else:
            rows = embed_readings(ctx_for, seed, i < args.controls,
                                  args.seconds)
        for what, readings, extra in rows:
            _emit(args.workload, {'cell': args.workload, 'seed': seed,
                                  'what': what, 'readings': readings,
                                  'seconds': time.perf_counter() - t0,
                                  **extra})
    return 0


if __name__ == '__main__':
    sys.exit(main())
