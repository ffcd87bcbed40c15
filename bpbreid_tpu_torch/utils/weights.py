"""Carry weights from the JAX package into the port.

The port's own copy of the name mapping in
bpbreid_tpu/utils/torch_weights.py: every flax variable path already
mirrors a torch ``state_dict`` key, so

  params/<p1>/.../kernel       -> '<p1>....weight'   (HWIO -> OIHW, IO -> OI)
  params/.../scale             -> '....weight'        (batchnorm)
  params/.../bias              -> '....bias'
  batch_stats/.../mean | var   -> '....running_mean | running_var'
  quant/.../<name>             -> '....<name>'        (int8 calibration)

The ``quant`` collection (the activation ranges of a calibrated int8
model: ``act_amax``, ``in_amax``, ``branch_amax_0``, ...) goes into the
non-persistent buffers of the same names (``ops/quant.py``).

``variables`` is a nested dict of numpy arrays, as
``jax.device_get(model.init(...))`` gives; nothing here imports JAX.
"""
import numpy as np
import torch

from bpbreid_tpu_torch.ops.quant import clear_calibration

__all__ = ['jax_variables_to_state_dict', 'load_jax_variables']


def _walk(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _torch_key(path, collection):
    *mods, leaf = path
    if collection == 'quant':
        return '.'.join(path)
    if collection == 'batch_stats':
        names = {'mean': 'running_mean', 'var': 'running_var'}
    else:
        names = {'kernel': 'weight', 'scale': 'weight', 'bias': 'bias',
                 'embedding': 'weight'}
    if leaf not in names:
        raise KeyError('no torch counterpart for {}/{}'.format(
            collection, '/'.join(path)))
    return '.'.join([*mods, names[leaf]])


def jax_variables_to_state_dict(variables):
    """Flax variables -> ``{torch key: np.ndarray}`` in torch layout.
    Collections other than ``params``, ``batch_stats`` and ``quant`` are
    ignored."""
    out = {}
    for coll in ('params', 'batch_stats', 'quant'):
        for path, v in _walk(variables.get(coll, {})):
            a = np.asarray(v)
            if path[-1] == 'kernel':
                if a.ndim == 4:                  # HWIO -> OIHW
                    a = np.transpose(a, (3, 2, 0, 1))
                elif a.ndim == 2:                # IO -> OI
                    a = np.transpose(a, (1, 0))
            out[_torch_key(path, coll)] = a
    return out


@torch.no_grad()
def load_jax_variables(module, variables):
    """Copy JAX variables into ``module``'s parameters and buffers.

    Raises if any parameter or buffer of ``module`` is left unfilled,
    if a JAX variable has no place in ``module``, or on a shape mismatch.
    The one exception: a BPBReID with ``learnable_attention_enabled``
    False keeps its ``pixel_classifier`` (as the torch reference does),
    which JAX never creates in that mode; those keys keep their values.
    With a ``quant`` collection, the module's recorded activation ranges
    are replaced by it (each module named by its path gets the buffers).
    """
    sd = jax_variables_to_state_dict(variables)
    quant = {_torch_key(path, 'quant'): v
             for path, v in _walk(variables.get('quant', {}))}
    for key in quant:
        sd.pop(key)
    if 'quant' in variables:
        clear_calibration(module)
        for key, v in quant.items():
            owner, _, name = key.rpartition('.')
            target = module.get_submodule(owner)
            ref = next(iter(module.parameters()))
            target.register_buffer(
                name, torch.as_tensor(np.asarray(v, np.float32),
                                      device=ref.device), persistent=False)
    own = module.state_dict()
    unused = set()
    if getattr(module, 'learnable_attention_enabled', True) is False:
        unused = {k for k in own if k.startswith('pixel_classifier.')}
    missing = sorted(set(own) - set(sd) - unused)
    unexpected = sorted(set(sd) - set(own))
    if missing or unexpected:
        raise KeyError('JAX variables do not cover the module: missing {}, '
                       'unexpected {}'.format(missing[:10], unexpected[:10]))
    for key, target in own.items():
        if key not in sd:
            continue
        src = torch.from_numpy(np.ascontiguousarray(sd[key]))
        if tuple(src.shape) != tuple(target.shape):
            raise ValueError('shape mismatch for {}: jax {} vs port {}'.format(
                key, tuple(src.shape), tuple(target.shape)))
        target.copy_(src.to(target.dtype))
    return module
