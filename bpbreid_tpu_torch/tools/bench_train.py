"""Train-step throughput of the part-based engine (port of
bpbreid_tpu/tools/bench_train.py, the train-side counterpart of the JAX
package's ``bench.py``).

Builds the CLI's part-based engine on the synthetic dataset at the
reference recipe's geometry (HRNet-W32, 384x128, bf16, ``five_v`` masks,
a 512-d after-pooling reduction, transforms ``rf rc re``, Adam at
3.5e-4, ``num_instances = batch // 8``) and times its train step on a
batch that already lies on the device: augmentation, forward, GiLt +
body-part-attention losses, backward and the optimizer's step. With
``--steps-per-dispatch`` k above 1 the batch is stacked k times and each
timed call is one ``forward_backward_multi`` of k steps: on a CUDA card a
CUDA graph of the step replayed k times (``engine/graphs.py``; Adam on
the card is ``capturable``), on the CPU k eager steps; with 1,
``forward_backward``.

Prints one JSON line: ``metric`` (JAX's name,
``<backbone>_bpbreid_train_step_<H>x<W>_b<B>[_spd<k>][_profiled]``),
``value`` (images/s), ``unit``, ``step_ms`` (the median of ``--repeats``
timed loops), ``runs_ms``, and the device: its name and, on a card,
its power limit as ``nvidia-smi`` gives it. ``--profile DIR`` wraps one
timed loop in ``torch.profiler`` and writes its Chrome trace under DIR
(read it with ``python -m bpbreid_tpu_torch.tools.profile_summary DIR``);
the record is then marked ``_profiled``. Runs on ``cuda`` unless
``--device cpu`` is given.

    python -m bpbreid_tpu_torch.tools.bench_train [--iters 20] ...
"""
import argparse
import json
import os
import subprocess
import time

__all__ = ['main', 'build_engine', 'power_limit']


def power_limit():
    """``name, power.limit`` of the card as ``nvidia-smi`` reports it, or
    None where ``nvidia-smi`` is missing."""
    try:
        out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True, check=True)
    except (OSError, subprocess.CalledProcessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else None


def build_engine(args, device):
    """The data manager and the part-based engine of the benchmark's
    recipe on ``device``."""
    from bpbreid_tpu_torch.config import get_default_config
    from bpbreid_tpu_torch.engine.part_based import ImagePartBasedEngine
    from bpbreid_tpu_torch.models import build_model
    from bpbreid_tpu_torch.ops.masks import compute_parts_num_and_names
    from bpbreid_tpu_torch.optim import build_optimizer
    from bpbreid_tpu_torch.scripts.main import build_datamanager

    cfg = get_default_config()
    cfg.use_gpu = device.type == 'cuda'
    cfg.model.name = 'bpbreid'
    cfg.model.compute_dtype = 'bfloat16'
    cfg.model.pretrained = False
    cfg.model.bpbreid.backbone = args.backbone
    cfg.model.bpbreid.masks.preprocess = 'five_v'
    cfg.model.bpbreid.dim_reduce_output = 512
    cfg.data.height, cfg.data.width = args.height, args.width
    cfg.data.sources = cfg.data.targets = ['synthetic']
    cfg.data.root = ''
    cfg.data.transforms = ['rf', 'rc', 're']
    cfg.data.workers = 2
    cfg.train.batch_size = cfg.test.batch_size = args.batch_size
    cfg.train.steps_per_dispatch = max(1, args.steps_per_dispatch)
    cfg.sampler.num_instances = max(1, args.batch_size // 8)
    compute_parts_num_and_names(cfg)

    dm = build_datamanager(cfg)
    model = build_model('bpbreid', dm.num_train_pids, loss='part_based',
                        pretrained=False, config=cfg, device=device,
                        seed=cfg.train.seed)
    engine = ImagePartBasedEngine.from_config(
        cfg, model, datamanager=dm,
        optimizer=build_optimizer(model, optim='adam', lr=3.5e-4),
        device=device)
    return dm, engine


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--batch-size', type=int, default=64)
    parser.add_argument('--height', type=int, default=384)
    parser.add_argument('--width', type=int, default=128)
    parser.add_argument('--backbone', default='hrnet32')
    parser.add_argument('--iters', type=int, default=20)
    parser.add_argument('--steps-per-dispatch', type=int, default=8,
                        help='train steps per dispatch '
                             '(cfg.train.steps_per_dispatch; 1 = the '
                             'per-batch path)')
    parser.add_argument('--profile', default=None, metavar='DIR',
                        help='wrap one timed loop in torch.profiler and '
                             'write its Chrome trace under DIR; summarize '
                             'with python -m '
                             'bpbreid_tpu_torch.tools.profile_summary DIR')
    parser.add_argument('--repeats', type=int, default=3,
                        help='timed repetitions; the record reports the '
                             'median step time and the list')
    parser.add_argument('--device', default='cuda',
                        help="torch device ('cuda' unless 'cpu' is asked)")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from bpbreid_tpu_torch import resolve_device

    device = resolve_device(args.device)
    dm, engine = build_engine(args, device)
    batch = next(iter(dm.train_loader))
    spd = max(1, args.steps_per_dispatch)
    keys = [k for k in ('image', 'mask', 'pid') if batch.get(k) is not None]
    if spd > 1:
        dbatch = {k: torch.as_tensor(np.stack([batch[k]] * spd)).to(device)
                  for k in keys}

        def step():
            return engine.forward_backward_multi(dbatch)

        def sync(out):
            return float(out[0][-1])
        n_steps = args.iters * spd
    else:
        dbatch = {k: torch.as_tensor(batch[k]).to(device) for k in keys}

        def step():
            return engine.forward_backward(dbatch)

        def sync(out):
            return float(out[0])
        n_steps = args.iters

    sync(step())                   # warm-up (and the graph's capture)

    def timed_loop():
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = step()
        sync(out)
        return (time.perf_counter() - t0) / n_steps

    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if device.type == 'cuda':
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(args.profile, exist_ok=True)
        with profile(activities=activities) as prof:
            dts = [timed_loop()]
        prof.export_chrome_trace(os.path.join(args.profile,
                                              'bench_train_trace.json'))
    else:
        dts = sorted(timed_loop() for _ in range(max(1, args.repeats)))
    dt = dts[len(dts) // 2] if len(dts) % 2 else \
        0.5 * (dts[len(dts) // 2 - 1] + dts[len(dts) // 2])
    record = {
        'metric': '{}_bpbreid_train_step_{}x{}_b{}{}'.format(
            args.backbone, args.height, args.width, args.batch_size,
            '_spd{}'.format(spd) if spd > 1 else ''),
        'value': round(args.batch_size / dt, 2),
        'unit': 'images/sec/chip',
        'step_ms': round(dt * 1e3, 2),
        'runs_ms': [round(d * 1e3, 2) for d in dts],
        'device': (torch.cuda.get_device_name(device)
                   if device.type == 'cuda' else 'cpu'),
        'name_power_limit': (power_limit() if device.type == 'cuda'
                             else None),
        'graphs': engine.train_graphs and spd > 1,
    }
    if args.profile:
        # tracing inflates the step: a profiled record is marked so
        record['metric'] += '_profiled'
        record['profiled'] = True
    print(json.dumps(record))
    return record


if __name__ == '__main__':
    main()
