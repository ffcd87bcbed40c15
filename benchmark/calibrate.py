#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the chip at the
cell's own size; the benchmark's own runs never run this.

    python3 benchmark/calibrate.py --workload <cell> --seeds <n> \
        [--controls <m>] [--first-seed <s>] [--seconds <w>] [--device <d>]

For each of ``n`` seeds it asks the cell's traffic kind for its
``calibration_readings(ctx_for, seed, controls, seconds)``: each runs the
cell's set-up as a run does (and, for a kind that serves requests, a
window of ``w`` seconds) and returns every candidate number of the
comparison between the program and the plain reference (``sound``), and
for the first ``m`` seeds the same numbers for the control and the
faults the kind can plant (``benchmark/traffic/<kind>.py`` says which).
A kind without ``calibration_readings`` is refused (exit 2), as is a
CUDA ``--device`` (the default) on a machine without one; ``--device
cpu`` rehearses a small cell here.

One JSON line per reading on standard output, also appended to
``chiprun_out/calibrate_<cell>.jsonl``.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _emit(root, cell, row):
    line = json.dumps(row)
    print(line, flush=True)
    os.makedirs(os.path.join(root, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(root, 'chiprun_out',
                           'calibrate_{}.jsonl'.format(cell)), 'a') as f:
        f.write(line + '\n')


def main(argv=None, root=ROOT):
    """``root``: the checkout that holds the cell (this one by default)."""
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, default=12)
    ap.add_argument('--controls', type=int, default=3)
    ap.add_argument('--first-seed', type=int, default=3_000_000_001)
    ap.add_argument('--seconds', type=float, default=2.0)
    ap.add_argument('--device', default='cuda:0')
    args = ap.parse_args(argv)
    from benchmark import core
    cell = core.find_cell(args.workload, root)
    traffic = core.load_traffic(cell.kind, root)
    readings = getattr(traffic, 'calibration_readings', None)
    if readings is None:
        print('calibrate: the traffic kind {!r} gives no calibration_readings'
              .format(cell.kind), file=sys.stderr)
        return 2
    import torch
    if torch.device(args.device).type == 'cuda' \
            and not torch.cuda.is_available():
        print('calibrate: CUDA is not available', file=sys.stderr)
        return 2

    def ctx_for(seed):
        return traffic.Traffic(core.Context(cell, seed, args.device))

    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        t0 = time.perf_counter()
        rows = readings(ctx_for, seed, i < args.controls, args.seconds)
        for what, values, extra in rows:
            _emit(root, args.workload, {
                'cell': args.workload, 'seed': seed, 'what': what,
                'readings': values, 'seconds': time.perf_counter() - t0,
                **extra})
    return 0


if __name__ == '__main__':
    sys.exit(main())
