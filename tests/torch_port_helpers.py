"""Shared helpers of the bpbreid_tpu_torch parity tests: inputs made
from a numpy seed go through the JAX function and its port; weights
cross over with ``bpbreid_tpu_torch.utils.weights``."""
import functools
import types

import jax
import numpy as np
import torch

# The tier-1 run has 6 xdist workers on 8 CPUs; torch's default of one
# intra-op thread per CPU in every worker oversubscribes them. Measured
# on the port's test files alone (-n 6): 180 s wall, 649 s summed over
# the files with the default; 68 s and 247 s with 2 threads.
TORCH_THREADS = 2


def limit_torch_threads():
    """Called at the top of every port test module."""
    torch.set_num_threads(TORCH_THREADS)


# depth-reduced HRNet-W32 at full widths (as tests/test_engine_e2e.py)
SMALL_W32 = {'stage2': (1, 2, (2, 2), (32, 64)),
             'stage3': (1, 3, (2, 2, 2), (32, 64, 128)),
             'stage4': (1, 4, (2, 2, 2, 2), (32, 64, 128, 256))}


def nchw(a):
    """numpy NHWC -> torch NCHW."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a))) \
        .permute(0, 3, 1, 2).contiguous()


def to_nhwc(t):
    """torch NCHW -> numpy NHWC f32."""
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def to_np(x):
    """JAX or torch array -> numpy f32 (bool stays bool)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.numpy() if x.dtype == torch.bool else x.float().numpy()
    a = np.asarray(x)
    return a if a.dtype == bool else a.astype(np.float32)


def randomize_variables(variables, seed):
    """Perturb BN affine params, biases and running statistics so the
    parity checks see non-trivial values everywhere (kernels keep their
    seeded init)."""
    rng = np.random.default_rng(seed)
    variables = jax.device_get(variables)

    def walk(tree, coll):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, coll)
                continue
            v = np.asarray(v)
            if coll == 'batch_stats' and k == 'mean':
                v = 0.1 * rng.standard_normal(v.shape)
            elif coll == 'batch_stats' and k == 'var':
                v = rng.uniform(0.5, 1.5, v.shape)
            elif k == 'scale':
                v = 1.0 + 0.1 * rng.standard_normal(v.shape)
            elif k == 'bias':
                v = 0.1 * rng.standard_normal(v.shape)
            out[k] = v.astype(np.float32)
        return out

    return {coll: walk(tree, coll) for coll, tree in variables.items()}


def port_variables(jax_model, port_model, *init_args):
    """JAX variables holding ``port_model``'s weights, for the tree of
    ``jax_model.init(key, *init_args)``: the tree comes from
    ``jax.eval_shape`` (traced, not compiled), each leaf from the port's
    ``state_dict`` in the JAX layout. Cheaper than a compiled ``init``
    of an HRNet on the CPU."""
    from bpbreid_tpu_torch.utils.weights import _torch_key
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                            *init_args)
    sd = {k: v.detach().float().numpy()
          for k, v in port_model.state_dict().items()}

    def fill(tree, coll, prefix):
        out = {}
        for k, v in tree.items():
            if hasattr(v, 'items'):
                out[k] = fill(v, coll, prefix + (k,))
                continue
            a = sd[_torch_key(prefix + (k,), coll)]
            if k == 'kernel':                    # OIHW -> HWIO, OI -> IO
                a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
            assert a.shape == tuple(v.shape), (prefix, k, a.shape, v.shape)
            out[k] = np.ascontiguousarray(a)
        return out

    return {coll: fill(tree, coll, ()) for coll, tree in shapes.items()}


def exact_bn_variables(variables, seed):
    """``variables`` with every batch norm's normalization exact in f32:
    mean 0, bias 0 and ``var + 1e-5 == 1``, so ``rsqrt`` is 1 in every
    implementation and ``(x - mean) * s + bias`` rounds once, with or
    without an FMA; the scales are drawn from ``seed``. The int8 tests use
    it: XLA's jitted BN contracts to an FMA and its f32 ``rsqrt`` differs
    from torch's by an ulp in about a third of the values, and a
    difference of one ulp ahead of a quantize can move an s8 value."""
    rng = np.random.default_rng(seed)
    var = np.float32(np.float32(1.0) - np.float32(1e-5))

    def walk(tree, coll):
        out, is_bn = {}, 'scale' in tree
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, coll)
                continue
            v = np.asarray(v, np.float32)
            if coll == 'batch_stats':
                v = np.zeros_like(v) if k == 'mean' else np.full_like(v, var)
            elif is_bn and k == 'bias':
                v = np.zeros_like(v)
            elif is_bn and k == 'scale':
                v = (1.0 + 0.2 * rng.standard_normal(v.shape)) \
                    .astype(np.float32)
            out[k] = v
        return out

    return {coll: walk(tree, coll) for coll, tree in variables.items()}


def assert_close(got, want, tol):
    """``got`` within ``tol`` of ``want``'s largest magnitude."""
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def jax_layout(t):
    """A port output (NCHW map, vector or tuple of them) in JAX's layout,
    as numpy."""
    if isinstance(t, tuple):
        return tuple(jax_layout(v) for v in t)
    return to_nhwc(t) if t.dim() == 4 else to_np(t)


def seeded_variables(jmodule, tmodule, *init_args, seed=1, **init_kwargs):
    """JAX variables for ``jmodule``'s tree (traced, not compiled:
    ``port_variables``) from ``tmodule``'s seeded init, with the affines,
    biases and BN statistics perturbed (``randomize_variables``); loaded
    into ``tmodule`` too. ``init_kwargs`` (``train=True``: the train-mode
    heads) stay static."""
    from bpbreid_tpu_torch.models.common import init_parameters
    from bpbreid_tpu_torch.utils.weights import load_jax_variables
    init_parameters(tmodule, torch.Generator().manual_seed(seed))
    traced = types.SimpleNamespace(
        init=functools.partial(jmodule.init, **init_kwargs))
    variables = randomize_variables(
        port_variables(traced, tmodule, *init_args), seed)
    load_jax_variables(tmodule, variables)
    return variables


def check_against_jax(jmodule, tmodule, x, eval_tol=1e-4, train_tol=1e-4,
                      stats_tol=1e-4):
    """``tmodule`` against ``jmodule`` (its ``__call__(x, train)``) on the
    same seeded variables: the eval output, then the train-mode output
    and every running statistic after it, each to its tolerance of the
    largest magnitude. JAX jits each mode: on the CPU that takes less
    time than dispatching the same model's primitives one by one."""
    from bpbreid_tpu_torch.utils.weights import jax_variables_to_state_dict
    x = np.asarray(x)
    variables = seeded_variables(jmodule, tmodule, x, train=True)
    want = jax.jit(functools.partial(jmodule.apply, train=False))(
        variables, x)
    with torch.no_grad():
        got = tmodule.eval()(nchw(x))
    jax.tree_util.tree_map(lambda g, w: assert_close(g, w, eval_tol),
                           jax_layout(got), want)
    want, state = jax.jit(functools.partial(
        jmodule.apply, train=True, mutable=['batch_stats']))(variables, x)
    with torch.no_grad():
        got = tmodule.train()(nchw(x))
    jax.tree_util.tree_map(lambda g, w: assert_close(g, w, train_tol),
                           jax_layout(got), want)
    stats = jax_variables_to_state_dict({'batch_stats': state['batch_stats']})
    own = tmodule.state_dict()
    assert stats
    for key, value in stats.items():
        assert_close(own[key], value, stats_tol)
    return tmodule
