"""Masked tensor helpers (port of bpbreid_tpu/ops/tensortools.py), and
``constant``, the device copy of host data that the steps read.

A captured CUDA graph (``engine/graphs.py``) may neither copy host data
to the device nor read the device back, so the code a step runs makes
its scalars with ``scalar_like`` (a fill on the device) and its index
vectors and interpolation matrices with ``constant`` (copied once, at
the first, eager step, then kept)."""
import torch

__all__ = ['constant', 'scalar_like', 'replace_values', 'masked_mean']

# (key, device, dtype) -> tensor; read-only tensors kept for the process
_CONSTANTS = {}


def constant(key, device, make=None, dtype=None):
    """The tensor of ``make()`` (numpy data or numbers; ``key`` itself
    when ``make`` is None) on ``device``, made at the first call for
    ``(key, device, dtype)`` and kept: later calls copy nothing, and a
    graph captured after the first call reads the kept tensor. ``key``
    must name the data; callers must not write to the tensor, which is
    never an inference tensor."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    full_key = (key, device, dtype)
    t = _CONSTANTS.get(full_key)
    if t is None:
        # a normal tensor even when first asked for under inference mode,
        # so that autograd may read it later
        with torch.inference_mode(False):
            t = torch.as_tensor(key if make is None else make(), dtype=dtype,
                                device=device)
        _CONSTANTS[full_key] = t
    return t


def scalar_like(value, x):
    """``value`` as a 0-d tensor of ``x``'s dtype on ``x``'s device: a
    fill on the device for a number, the tensor converted otherwise."""
    if isinstance(value, torch.Tensor):
        return value.to(dtype=x.dtype, device=x.device)
    return torch.full((), value, dtype=x.dtype, device=x.device)


def replace_values(x, mask, value):
    """Return ``x`` with entries where ``mask`` is True replaced by ``value``."""
    return torch.where(mask, scalar_like(value, x), x)


def masked_mean(x, mask, dim=0):
    """Weighted mean of ``x`` over ``dim`` using ``mask`` as weights.

    Entries whose weights sum to zero are marked with ``-1``, the
    sentinel for "this pair could not be compared". ``mask`` may be
    boolean or continuous in [0, 1].
    """
    mask = mask.to(x.dtype)
    weights = mask.sum(dim=dim)
    safe_weights = weights + (weights == 0).to(x.dtype)
    mean = (x * mask).sum(dim=dim) / safe_weights
    return torch.where(weights == 0, scalar_like(-1.0, x), mean)
