"""Process groups for data parallelism and gallery-sharded retrieval (port
of bpbreid_tpu/parallel/mesh.py).

JAX runs one process over a 1-D ``data`` mesh of devices and lets XLA
insert the cross-device reductions. Here there is one process per device
(a rank of ``torch.distributed``), and a ``Mesh`` is that rank's view:
its rank, the world size, its device, the backend and the group. Every
rank holds the same replicated model and takes its contiguous slice of
the global batch (``shard_array``); what the one-process step computes
over the global batch, the ranks compute with the collectives below.

The collectives are built from ``all_reduce`` and ``broadcast`` alone:
those two are what gloo offers on CUDA tensors as well as on CPU ones
(no ``all_gather``, ``reduce_scatter`` or ``all_to_all``), so the same
code runs on gloo (CPU or GPU) and on NCCL. A gather is an ``all_reduce``
(sum) of a zero buffer in which each rank wrote its slice: exact in
floating point, since every entry is one value plus zeros.
``collective_counts`` counts the calls by name.
"""
import collections
import datetime

import torch
import torch.distributed as dist

__all__ = ['DATA_AXIS', 'Mesh', 'make_mesh', 'init_process_group',
           'replicate', 'shard_batch_spec', 'shard_array', 'shard_bounds',
           'all_reduce', 'all_reduce_flat', 'all_reduce_mean', 'all_gather',
           'gather_live',
           'gather_tree', 'broadcast', 'collective_counts',
           'reset_collective_counts']

DATA_AXIS = 'data'
collective_counts = collections.Counter()
# a rank that dies leaves the others waiting in a collective: this bounds
# the wait, after which the collective raises
TIMEOUT = datetime.timedelta(minutes=10)


def reset_collective_counts():
    collective_counts.clear()


class Mesh:
    """A rank's view of the 1-D data mesh: ``rank``, ``size`` (the world
    size), its ``device``, the ``backend`` and the process ``group``
    (None: the default group)."""
    axis_names = (DATA_AXIS,)

    def __init__(self, rank, size, device, backend, group=None):
        self.rank, self.size = int(rank), int(size)
        self.device = torch.device(device)
        self.backend, self.group = backend, group


def init_process_group(rank, world_size, init_method, backend=None,
                       device=None):
    """Join the default process group (``tcp://localhost:<port>`` or
    ``file://<path>`` as ``init_method``) and return its ``Mesh``.
    ``backend`` defaults to NCCL for a CUDA ``device`` and gloo
    otherwise; ``device`` to ``cuda:<rank>`` with NCCL, else the CPU."""
    if device is None:
        device = 'cuda:{}'.format(rank) if backend == 'nccl' else 'cpu'
    device = torch.device(device)
    if backend is None:
        backend = 'nccl' if device.type == 'cuda' else 'gloo'
    if device.type == 'cuda':
        if device.index is None:
            device = torch.device('cuda', torch.cuda.current_device())
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=TIMEOUT)
    return make_mesh(world_size, devices=[device] * world_size)


def make_mesh(n_devices=None, devices=None, group=None):
    """The ``Mesh`` of this rank in the initialized process group.

    Args:
        n_devices: the world size expected (None: whatever it is).
        devices: each rank's device, indexed by rank; None gives
            ``cuda:<current device>`` under NCCL and the CPU under gloo.
        group: a process group, or None for the default one.
    """
    if not dist.is_initialized():
        raise RuntimeError('torch.distributed is not initialized: call '
                           'parallel.init_process_group in every rank first')
    size = dist.get_world_size(group)
    if n_devices is not None and int(n_devices) != size:
        raise ValueError('a {}-device mesh asked of a process group of {} '
                         'ranks'.format(n_devices, size))
    rank = dist.get_rank(group)
    backend = dist.get_backend(group)
    if devices is not None:
        device = devices[rank]
    elif backend == 'nccl':
        device = torch.device('cuda', torch.cuda.current_device())
    else:
        device = torch.device('cpu')
    return Mesh(rank, size, device, backend, group)


def shard_bounds(n, mesh):
    """``(lo, hi)`` of this rank's contiguous share of ``n`` rows; raises
    unless the world size divides ``n``."""
    if n % mesh.size:
        raise ValueError('{} rows do not split over a {}-rank mesh'.format(
            n, mesh.size))
    per = n // mesh.size
    return mesh.rank * per, (mesh.rank + 1) * per


def shard_array(x, mesh, axis=0):
    """This rank's contiguous slice of ``x`` along ``axis`` (a view); the
    world size must divide the axis (no implicit padding, as in JAX)."""
    lo, hi = shard_bounds(x.shape[axis], mesh)
    return x.narrow(axis, lo, hi - lo)


def shard_batch_spec(mesh):
    """The sharding of an array whose leading axis is the batch: a
    function giving this rank's slice."""
    return lambda x: shard_array(x, mesh, 0)


def _wide(t):
    """The type a collective carries ``t`` in: bool and the half floats
    go as uint8 and f32 (exact; gloo sums neither bool nor every half
    type)."""
    if t.dtype == torch.bool:
        return torch.uint8
    if t.dtype in (torch.float16, torch.bfloat16):
        return torch.float32
    return t.dtype


def all_reduce(t, mesh):
    """Sum ``t`` over the ranks, in place; returns ``t``."""
    collective_counts['all_reduce'] += 1
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


class _AllReduceMean(torch.autograd.Function):
    """The mean over the ranks, differentiable. The gradient that reaches
    the output on each rank is that rank's share of the total (its own
    slice of the loss's inputs is live, as ``gather_live`` makes it); each
    rank's input moves the mean by 1/size, so its gradient is the sum of
    the shares over the ranks divided by the world size."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return all_reduce(t.detach().clone(), mesh) / mesh.size

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous().clone(), ctx.mesh) \
            / ctx.mesh.size, None


def all_reduce_mean(t, mesh):
    """The mean of ``t`` over the ranks (every rank's ``t`` of one shape),
    with a backward: the mean of a statistic that each rank takes over an
    equal slice is the statistic of the global batch."""
    return _AllReduceMean.apply(t, mesh)


def all_reduce_flat(tensors, mesh):
    """Sum each of ``tensors`` over the ranks in place, through one
    ``all_reduce`` of a flat buffer a dtype."""
    by_dtype = collections.defaultdict(list)
    for t in tensors:
        by_dtype[t.dtype].append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        all_reduce(flat, mesh)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
    return tensors


def broadcast(t, mesh, src=0):
    """Rank ``src``'s ``t`` on every rank, in place; returns ``t``."""
    collective_counts['broadcast'] += 1
    dist.broadcast(t, src=src, group=mesh.group)
    return t


def all_gather(t, mesh, dim=0):
    """Every rank's ``t`` (equal shapes) concatenated along ``dim`` in rank
    order, on every rank. Not differentiable: see ``gather_live``."""
    t = t.detach()
    n = t.shape[dim]
    shape = list(t.shape)
    shape[dim] = n * mesh.size
    buf = torch.zeros(shape, dtype=_wide(t), device=t.device)
    buf.narrow(dim, mesh.rank * n, n).copy_(t)
    all_reduce(buf, mesh)
    return buf.to(t.dtype)


def gather_live(t, mesh, dim=0):
    """``all_gather`` with this rank's own slice spliced back in live: the
    other ranks' slices are constants, so a loss of the result sends its
    gradient through this rank's slice only. With the gradients summed
    over the ranks afterwards, that is the one-process gradient."""
    if mesh.size == 1:
        return t
    gathered = all_gather(t, mesh, dim)
    n = t.shape[dim]
    lo = mesh.rank * n
    return torch.cat([gathered.narrow(dim, 0, lo), t,
                      gathered.narrow(dim, lo + n,
                                      gathered.shape[dim] - lo - n)], dim)


def gather_tree(tree, mesh, dim=0):
    """``gather_live`` over the tensors of a tree of dicts, lists and
    tuples (None passes through); tensors that need no gradient are
    gathered as constants."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: gather_tree(v, mesh, dim) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_tree(v, mesh, dim) for v in tree)
    if mesh.size == 1:
        return tree
    if tree.requires_grad:
        return gather_live(tree, mesh, dim)
    return all_gather(tree, mesh, dim)


def replicate(mesh, module):
    """Rank 0's parameters and buffers on every rank (in place, one
    ``broadcast`` of a flat buffer a dtype); returns ``module``."""
    by_dtype = collections.defaultdict(list)
    for t in list(module.parameters()) + list(module.buffers()):
        by_dtype[t.dtype].append(t)
    with torch.no_grad():
        for dtype, group in by_dtype.items():
            flat = torch.cat([t.reshape(-1) for t in group])
            wide = flat.to(_wide(flat))
            broadcast(wide, mesh)
            flat = wide.to(dtype)
            offset = 0
            for t in group:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()
    return module
