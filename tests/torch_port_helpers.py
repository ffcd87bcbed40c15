"""Shared helpers of the bpbreid_tpu_torch parity tests: inputs made
from a numpy seed go through the JAX function and its port; weights
cross over with ``bpbreid_tpu_torch.utils.weights``."""
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
