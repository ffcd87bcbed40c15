"""Rank side of the data-parallel tests of bpbreid_tpu_torch.

``spawn`` starts gloo ranks with ``torch.multiprocessing``; each
child imports this module to find its function, so it imports neither
``jax`` nor ``tests/conftest.py``. The ranks meet through a file in the
test's ``tmp_path`` (no TCP port for parallel test workers to fight
over), run torch on one thread each, run one function of
this module on the same payload and save what it returns.

The step functions build the same engine in the parent (the
one-process step) and in every rank (``parallel.distribute_engine``).
"""
import os

import numpy as np
import torch

LR, WD = 3.5e-4, 5e-4


class Ranks:
    """Ranks started by ``start``: ``send(payload)`` hands them their
    input, ``results()`` waits for them."""

    def __init__(self, context, out_dir, world_size):
        self.context, self.out_dir = context, out_dir
        self.world_size = world_size

    def send(self, payload):
        """Write the payload where the ranks wait for it (atomically)."""
        path = os.path.join(self.out_dir, 'payload.pt')
        torch.save(payload, path + '.tmp')
        os.replace(path + '.tmp', path)
        return self

    def results(self):
        """The ranks' results in rank order; raises if a rank failed."""
        while not self.context.join():
            pass
        return [torch.load(os.path.join(self.out_dir,
                                        'rank{}.pt'.format(r)),
                           weights_only=False)
                for r in range(self.world_size)]


def start(fn, world_size, tmp_path, payload=None):
    """Start ``fn(mesh, payload)`` on ``world_size`` gloo ranks and
    return at once: a ``Ranks``. Without ``payload`` the ranks start up
    (imports, the process group) while the caller makes it, and wait for
    ``Ranks.send``."""
    import torch.multiprocessing as mp
    tmp = os.path.join(str(tmp_path), 'ranks{}'.format(world_size))
    os.makedirs(tmp, exist_ok=True)
    init = 'file://' + os.path.join(tmp, 'rendezvous')
    context = mp.start_processes(_entry, args=(world_size, init, fn, tmp),
                                 nprocs=world_size, join=False,
                                 start_method='spawn')
    ranks = Ranks(context, tmp, world_size)
    return ranks if payload is None else ranks.send(payload)


def spawn(fn, world_size, tmp_path, payload):
    """``fn(mesh, payload)`` on ``world_size`` gloo ranks; returns the
    ranks' results in rank order. A rank that raises fails the call."""
    return start(fn, world_size, tmp_path, payload).results()


def _entry(rank, world_size, init, fn, out_dir):
    # one thread a rank: the parallel test workers already fill the CPUs
    torch.set_num_threads(1)
    import time

    import torch.distributed as dist
    from bpbreid_tpu_torch.engine.part_based import \
        ImagePartBasedEngine  # noqa: F401  (imported while waiting)
    from bpbreid_tpu_torch.parallel.mesh import init_process_group
    # the first optimizer a process builds imports torch._dynamo (seconds)
    torch.optim.Adam([torch.zeros(1, requires_grad=True)])
    mesh = init_process_group(rank, world_size, init)
    try:
        path = os.path.join(out_dir, 'payload.pt')
        while not os.path.exists(path):
            time.sleep(0.02)
        payload = torch.load(path, weights_only=False)
        torch.save(fn(mesh, payload),
                   os.path.join(out_dir, 'rank{}.pt'.format(rank)))
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------------
# engines
# ----------------------------------------------------------------------
def part_based_engine(payload):
    """The part-based engine of ``payload`` (``model_kwargs``,
    ``state_dict``, ``transforms``) on the CPU, Adam at LR, WD."""
    from bpbreid_tpu_torch.config import get_default_config
    from bpbreid_tpu_torch.data.augment import mask_chain_kwargs
    from bpbreid_tpu_torch.engine.part_based import ImagePartBasedEngine
    from bpbreid_tpu_torch.models.bpbreid import BPBreID
    from bpbreid_tpu_torch.optim import build_optimizer
    cfg = get_default_config()
    cfg.model.bpbreid.masks.preprocess = 'five_v'
    cfg.data.transforms = list(payload['transforms'])
    model = BPBreID(**payload['model_kwargs'])
    model.load_state_dict(payload['state_dict'])
    return ImagePartBasedEngine.from_config(
        cfg, model, mask_chain_kwargs(cfg), device='cpu',
        optimizer=build_optimizer(model, optim='adam', lr=LR,
                                  weight_decay=WD))


GLOBAL_ENGINES = ('softmax', 'triplet', 'video_softmax', 'video_triplet')


def global_engine(payload):
    """A softmax, triplet or video engine (``payload['kind']``) on a copy
    of ``payload['model']`` (a zoo model of that loss) on the CPU, f32."""
    import copy
    import types

    from bpbreid_tpu_torch.config import get_default_config
    from bpbreid_tpu_torch.engine.image import (ImageSoftmaxEngine,
                                               ImageTripletEngine)
    from bpbreid_tpu_torch.engine.video import (VideoSoftmaxEngine,
                                               VideoTripletEngine)
    from bpbreid_tpu_torch.optim import build_optimizer
    kind = payload['kind']
    cfg = get_default_config()
    cfg.model.compute_dtype = 'float32'
    cfg.data.transforms = list(payload['transforms'])
    model = copy.deepcopy(payload['model'])
    dm = types.SimpleNamespace(transforms=cfg.data.transforms,
                               norm_mean=cfg.data.norm_mean,
                               norm_std=cfg.data.norm_std)
    cls = {'softmax': ImageSoftmaxEngine, 'triplet': ImageTripletEngine,
           'video_softmax': VideoSoftmaxEngine,
           'video_triplet': VideoTripletEngine}[kind]
    return cls(dm, model, build_optimizer(model, optim='adam', lr=LR,
                                          weight_decay=WD),
               config=cfg, device='cpu')


def build_engine(payload):
    if payload['kind'] == 'part_based':
        return part_based_engine(payload)
    return global_engine(payload)


def run_steps(engine, payload):
    """The engine's train steps on ``payload['batches']`` with
    ``payload['draws']`` (the global batch's); per step the loss, the
    gradients and the state after it (parameters and buffers)."""
    out = []
    for batch, draws in zip(payload['batches'], payload['draws']):
        loss, _ = engine.forward_backward(batch, draws=draws)
        out.append({
            'loss': float(loss),
            'grads': {k: v.grad.detach().clone()
                      for k, v in engine.model.named_parameters()},
            'state': {k: v.detach().clone()
                      for k, v in engine.model.state_dict().items()}})
    return out


_bn_counts = None
BN_ENTRIES = ('bn_stats', 'bn_local_sums', 'bn_apply', 'bn_apply_sums',
              'bn_grad_stats', 'bn_grad_local_sums', 'bn_dx')


def record_bn_entries():
    """Count the calls that ``models.common``'s batch norm makes to the
    ``ops/cuda/batchnorm.py`` entries (``BN_ENTRIES``) and, of its
    ``all_reduce`` calls, those on a copy of the gradient sums that
    ``bn_grad_local_sums`` wrote itself (``grad_sums_in_place``). Returns
    the counter; the wrappers stay for the rest of this process, and a
    second call returns the same counter."""
    import collections

    from bpbreid_tpu_torch.models import common
    global _bn_counts
    if _bn_counts is not None:
        return _bn_counts
    counts = _bn_counts = collections.Counter()
    grad_sums = set()

    def counted(name, fn):
        def call(*args, **kwargs):
            counts[name] += 1
            out = fn(*args, **kwargs)
            if name == 'bn_grad_local_sums':
                grad_sums.add(out[2].data_ptr())
            return out
        return call

    for name in BN_ENTRIES:
        setattr(common, name, counted(name, getattr(common, name)))
    all_reduce = common.all_reduce

    def reduce(t, mesh):
        if t.data_ptr() in grad_sums:
            counts['grad_sums_in_place'] += 1
        return all_reduce(t, mesh)
    common.all_reduce = reduce
    return counts


def distributed_steps(mesh, payloads):
    """Each payload's engine distributed over ``mesh`` and stepped; with
    the collective calls of each run and the batch norm entries it
    called (``record_bn_entries``)."""
    from bpbreid_tpu_torch.parallel import distribute_engine
    from bpbreid_tpu_torch.parallel.mesh import (collective_counts,
                                                 reset_collective_counts)
    bn = record_bn_entries()
    results = []
    for payload in payloads:
        engine = build_engine(payload)
        distribute_engine(engine, mesh)
        reset_collective_counts()
        bn.clear()
        steps = run_steps(engine, payload)
        results.append({'steps': steps,
                        'collectives': dict(collective_counts),
                        'bn_entries': dict(bn)})
    return results


def steps_at_4_and_2_ranks(mesh, payload):
    """The payload's steps on the 4 ranks of ``mesh``, then on a 2-rank
    group of ranks 0 and 1, while rank 2 runs the one-process steps on the
    global batch (one spawn of 4 processes for all three): ``{4: result,
    2: result}`` on ranks 0 and 1, ``{4: ..., 1: steps}`` on rank 2."""
    import torch.distributed as dist
    from bpbreid_tpu_torch.parallel.mesh import make_mesh
    out = {4: distributed_steps(mesh, [payload])}
    pair = dist.new_group([0, 1])
    if mesh.rank < 2:
        out[2] = distributed_steps(make_mesh(2, group=pair), [payload])
    elif mesh.rank == 2:
        bn = record_bn_entries()
        bn.clear()
        out[1] = one_process_steps(payload)
        out['bn_entries_one'] = dict(bn)
    return out


def one_process_steps(payload):
    """The same steps in this process, on the global batch."""
    return run_steps(build_engine(payload), payload)


def _zero_in_exact_arithmetic(key):
    """The bias of a Dense ahead of a train-mode BN (BPBReID's dim
    reduction, OSNet's ``fc``): its gradient is zero but for float noise."""
    return key.endswith(('_after_pooling_dim_reduce.layers.0.bias',
                         'fc.0.bias'))


def grad_errors(got, want):
    """Gradients ``got`` (tensors) against ``want`` (arrays or tensors):
    the relative L2 over all tensors, and the worst and the median
    per-tensor error over the tensor's largest |entry|. The biases that
    are zero in exact arithmetic must be below 1e-6 on both sides and are
    left out."""
    rel, num, den = [], 0.0, 0.0
    for key, w in want.items():
        w = np.asarray(w, np.float64)
        g = got[key].numpy().astype(np.float64)
        if _zero_in_exact_arithmetic(key):
            assert np.abs(w).max() < 1e-6 and np.abs(g).max() < 1e-6, key
            continue
        rel.append(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
        num += np.sum((g - w) ** 2)
        den += np.sum(w ** 2)
    return np.sqrt(num / den), max(rel), float(np.median(rel))


def check_state(got, want, before, g_got, g_want):
    """The state after step 1 (``got``, tensors) against ``want`` (arrays
    or tensors) from the same ``before``: BN running statistics to 1e-6
    of their scale; parameters to Adam's first update from each side's
    gradient (``g_got``, ``g_want``), to 1e-6."""
    for key, w in want.items():
        w = np.asarray(w)
        diff = np.abs(got[key].numpy() - w)
        if key.endswith(('running_mean', 'running_var')):
            assert diff.max() <= 1e-6 * (1 + np.abs(w).max()), key
            continue
        p0 = before[key].numpy()
        u = [(np.asarray(g) + WD * p0) / (np.abs(np.asarray(g) + WD * p0)
                                          + 1e-8)
             for g in (g_got[key], g_want[key])]
        assert np.abs(diff - LR * np.abs(u[0] - u[1])).max() <= 1e-6, key


# ----------------------------------------------------------------------
# retrieval and collectives
# ----------------------------------------------------------------------
def retrieval_checks(mesh, payload):
    """Every rank's ``sharded_bp_distance`` and ``sharded_cmc_map`` on the
    payload's features and distances, the collectives' round trips and
    the dropout masks drawn under the mesh."""
    from bpbreid_tpu_torch.models.common import GeneratorDropout
    from bpbreid_tpu_torch.parallel import (sharded_bp_distance,
                                            sharded_cmc_map, shard_array)
    from bpbreid_tpu_torch.parallel.mesh import (all_gather,
                                                 all_reduce_mean,
                                                 gather_live)
    out = {}
    for name, case in payload['distance_cases'].items():
        d, bp, ng = sharded_bp_distance(mesh, *case['args'], **case['kw'])
        out[name] = (d, bp, ng)
    for name, case in payload['cmc_cases'].items():
        out[name] = sharded_cmc_map(mesh, *case['args'], **case['kw'])
    # a gather of mixed dtypes, and its live slice's gradient
    x = shard_array(payload['gather_input'], mesh).clone()
    out['gather'] = {dt: all_gather(x.to(dt), mesh)
                     for dt in (torch.float32, torch.bfloat16, torch.bool,
                                torch.int64)}
    live = x.clone().requires_grad_(True)
    g = gather_live(live, mesh)
    (g * payload['gather_weight']).sum().backward()
    out['gather_live_grad'] = live.grad
    m = x.mean(dim=0).requires_grad_(True)
    mean = all_reduce_mean(m, mesh)
    # each rank's share of a loss of the mean: rank r weighs it by row r
    (mean * payload['gather_weight'][mesh.rank]).sum().backward()
    out['mean'], out['mean_grad'] = mean.detach(), m.grad
    drop = GeneratorDropout(0.5)
    drop.generator = torch.Generator().manual_seed(payload['seed'])
    drop.mesh = mesh
    drop.train()
    out['dropout'] = drop(x)
    return out
