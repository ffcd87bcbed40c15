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
    from bpbreid_tpu_torch.utils.weights import _torch_key, is_raw_parameter
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
            elif is_raw_parameter(prefix + (k,), coll) and a.ndim == 4:
                a = a.transpose(0, 2, 3, 1)      # NCHW -> NHWC
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
    if isinstance(t, (tuple, list)):
        return type(t)(jax_layout(v) for v in t)
    return to_nhwc(t) if t.dim() == 4 else to_np(t)


def seeded_variables(jmodule, tmodule, *init_args, seed=1, initialized=False,
                     **init_kwargs):
    """JAX variables for ``jmodule``'s tree (traced, not compiled:
    ``port_variables``) from ``tmodule``'s seeded init (``initialized``:
    the weights the caller gave it), with the affines, biases and BN
    statistics perturbed (``randomize_variables``); loaded into
    ``tmodule`` too. ``init_kwargs`` (``train=True``: the train-mode
    heads) stay static."""
    from bpbreid_tpu_torch.models.common import init_parameters
    from bpbreid_tpu_torch.utils.weights import load_jax_variables
    if not initialized:
        init_parameters(tmodule, torch.Generator().manual_seed(seed))
    traced = types.SimpleNamespace(
        init=functools.partial(jmodule.init, **init_kwargs))
    variables = randomize_variables(
        port_variables(traced, tmodule, *init_args), seed)
    load_jax_variables(tmodule, variables)
    return variables


def _is_dropout(module, method_name):
    """``capture_intermediates`` filter: the outputs of flax's dropouts."""
    return type(module).__name__ == 'Dropout'


def jax_dropout_masks(intermediates):
    """The keep-masks of every flax ``nn.Dropout`` a train-mode apply
    captured (``capture_intermediates=True``), in call order: an output
    entry is kept where it is not 0."""
    masks = []

    def walk(tree):
        for k, v in tree.items():
            if k.startswith('Dropout'):
                masks.append(np.asarray(v['__call__'][0]) != 0)
            elif isinstance(v, dict):
                walk(v)
    walk(intermediates)
    return masks


def apply_jax_masks(tmodule, masks):
    """Make the ``GeneratorDropout``s of ``tmodule`` keep the entries of
    ``masks`` (numpy, in JAX's layout; a port input of another layout
    takes the transpose of the mask of its shape), kept entries doubled
    (rate 0.5), as flax's dropout scales them."""
    from bpbreid_tpu_torch.models.common import GeneratorDropout
    drops = [m for m in tmodule.modules() if isinstance(m, GeneratorDropout)]
    assert len(drops) == len(masks), (len(drops), len(masks))
    for module, mask in zip(drops, masks):
        def forward(x, mask=mask, rate=module.rate):
            m = mask if mask.shape == tuple(x.shape) else \
                np.swapaxes(mask, 1, 2)
            keep = torch.from_numpy(np.ascontiguousarray(m))
            return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
        module.forward = forward


def check_against_jax(jmodule, tmodule, x, eval_tol=1e-4, train_tol=1e-4,
                      stats_tol=1e-4, extra=(), variables=None,
                      outputs=False):
    """``tmodule`` against ``jmodule`` (its ``__call__(x, *extra,
    train)``) on the same seeded variables (``variables``, or
    ``seeded_variables``'s): the eval output, then the train-mode output
    and every running statistic after it, each to its tolerance of the
    largest magnitude. JAX jits each mode: on the CPU that takes less
    time than dispatching the same model's primitives one by one.

    A model with dropout runs JAX's train mode with a dropout key and
    its captured keep-masks in the port (``apply_jax_masks``). Returns
    the module; with ``outputs``, ``(module, port train output, JAX train
    output)``."""
    from bpbreid_tpu_torch.utils.weights import jax_variables_to_state_dict
    x = np.asarray(x)
    extra = tuple(np.asarray(e) for e in extra)
    if variables is None:
        variables = seeded_variables(jmodule, tmodule, x, *extra, train=True)
    want = jax.jit(functools.partial(jmodule.apply, train=False))(
        variables, x, *extra)
    with torch.no_grad():
        got = tmodule.eval()(nchw(x), *map(nchw, extra))
    jax.tree_util.tree_map(lambda g, w: assert_close(g, w, eval_tol),
                           jax_layout(got), want)
    train = jax.jit(functools.partial(
        jmodule.apply, train=True, capture_intermediates=_is_dropout,
        mutable=['batch_stats', 'intermediates']))
    rngs = {'dropout': jax.random.PRNGKey(3)}
    want, state = train(variables, x, *extra, rngs=rngs)
    apply_jax_masks(tmodule,
                    jax_dropout_masks(state.get('intermediates', {})))
    with torch.no_grad():
        got = tmodule.train()(nchw(x), *map(nchw, extra))
    jax.tree_util.tree_map(lambda g, w: assert_close(g, w, train_tol),
                           jax_layout(got), want)
    stats = jax_variables_to_state_dict(
        {'batch_stats': state.get('batch_stats', {})})
    own = tmodule.state_dict()
    # every running statistic is compared, and a model without one has
    # none in either package
    assert stats or not any(k.endswith('running_mean') for k in own)
    for key, value in stats.items():
        assert_close(own[key], value, stats_tol)
    return (tmodule, got, want) if outputs else tmodule


def _inverse_cdf_lecun_normal_(weight, fan_in, generator):
    import math
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    lo = (1.0 + math.erf(-math.sqrt(2.0))) / 2.0
    weight.uniform_(2.0 * lo - 1.0, 1.0 - 2.0 * lo, generator=generator)
    weight.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0).mul_(std)


def zoo_init(module, seed):
    """``init_parameters`` with its truncated normal drawn by the inverse
    CDF. The tests need the distribution, not torch's bits: the
    ``trunc_normal_`` of this sandbox's torch is a rejection sampler that
    takes seconds on the zoo's 10^7-10^8 weights (SENet-154, MuDeep's
    head)."""
    from bpbreid_tpu_torch.models import common
    own = common._lecun_normal_
    common._lecun_normal_ = _inverse_cdf_lecun_normal_
    try:
        common.init_parameters(module, torch.Generator().manual_seed(seed))
    finally:
        common._lecun_normal_ = own


def zoo_images(seed, n=4, h=64, w=32, c=3):
    """``[n, h, w, c]`` f32 images of varied brightness and contrast (an
    offset in [-1, 1) and a scale in [0.5, 2) an image, on unit normal
    noise). Models that batch-normalize pooled vectors (MLFN's gates,
    HACNN's channel attention) are ill-conditioned in train mode on
    near-alike images: f32 noise alone then moves their output by a large
    share of its magnitude."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1.0, 1.0, (n, 1, 1, 1))
            + rng.uniform(0.5, 2.0, (n, 1, 1, 1))
            * rng.standard_normal((n, h, w, c))).astype(np.float32)


def check_zoo_constructor(jmodel, tmodel, hw, *extra_shapes):
    """A registry constructor at full depth: JAX's variable tree (traced
    at ``hw``) loads key for key into ``tmodel`` and none is left over
    (``load_jax_variables`` raises otherwise, and on a shape); then
    ``tmodel`` in eval mode at ``hw`` on two images (and seeded extra
    inputs of ``extra_shapes``, NHWC) gives a finite output. Returns
    it."""
    x = zoo_images(11, 2, *hw)
    extra = [zoo_images(12 + i, 2, *shape)
             for i, shape in enumerate(extra_shapes)]
    zoo_init(tmodel, 1)
    seeded_variables(jmodel, tmodel, x[:1], *[e[:1] for e in extra],
                     initialized=True, train=True)
    with torch.no_grad():
        out = tmodel.eval()(nchw(x), *map(nchw, extra))
    for leaf in jax.tree_util.tree_leaves(jax_layout(out)):
        assert np.isfinite(leaf).all()
    return out


def check_bpbreid_backbone(jbpbreid, tbpbreid, hw, seed):
    """BPBReID (after-pooling reduction) on a zoo backbone against JAX's,
    eval mode on two images: embeddings and pixel scores to 1e-3 (as the
    other BPBReID tests hold them), visibility scores equal. Returns the
    port's backbone map."""
    x = jax.numpy.asarray(zoo_images(seed, 2, *hw))
    zoo_init(tbpbreid, seed)
    variables = seeded_variables(jbpbreid, tbpbreid, x, None, seed=seed,
                                 initialized=True)
    want = jax.jit(lambda v, x: jbpbreid.apply(v, x, None, train=False))(
        variables, x)
    backbone = tbpbreid.backbone_appearance_feature_extractor
    with torch.no_grad():
        got = tbpbreid.eval()(nchw(x))
        fmap = backbone.eval()(nchw(x))
    for key in want[0]:
        assert_close(got[0][key], want[0][key], 1e-3)
    for key in want[1]:
        np.testing.assert_array_equal(to_np(got[1][key]),
                                      to_np(want[1][key]))
    assert_close(got[3], np.transpose(np.asarray(want[3]), (0, 3, 1, 2)),
                 1e-3)
    return fmap


def check_zoo_model(name, hw, n=4, seed=0, loss='softmax', **kwargs):
    """The registry constructor ``name`` of both packages at full depth,
    through ``check_against_jax`` on ``n`` ``zoo_images`` at ``hw``: eval
    to 1e-4, train mode to 1e-3, statistics to 1e-4 (``kwargs`` as
    ``check_against_jax``'s)."""
    from bpbreid_tpu import models as jmodels
    from bpbreid_tpu_torch.models import BACKBONES
    kwargs.setdefault('train_tol', 1e-3)
    jm = jmodels.build_model(name, 7, loss=loss, pretrained=False)
    tm = BACKBONES[name](7, loss=loss)
    x = zoo_images(seed, n, *hw)
    zoo_init(tm, 1)
    variables = seeded_variables(jm, tm, x, initialized=True, train=True)
    return check_against_jax(jm, tm, x, variables=variables, **kwargs)


def check_zoo_bpbreid(name, hw, seed=7):
    """``check_bpbreid_backbone`` on BPBReID (5 parts, a 32-d after-pooling
    reduction) over the registry backbone ``name``; also checks that the
    backbone's ``feature_dim`` is its map's width. Returns the map."""
    from bpbreid_tpu.models.bpbreid import BPBreID as JBPBreID
    from bpbreid_tpu_torch.models.bpbreid import BPBreID as TBPBreID
    kw = dict(num_classes=7, parts_num=5, dim_reduce_output=32, backbone=name)
    tbpbreid = TBPBreID(**kw)
    fmap = check_bpbreid_backbone(JBPBreID(**kw), tbpbreid, hw, seed)
    backbone = tbpbreid.backbone_appearance_feature_extractor
    assert fmap.shape[1] == backbone.feature_dim, (fmap.shape,
                                                   backbone.feature_dim)
    return fmap


# aten ops that read the device back or make a tensor from host data:
# neither may run inside a captured CUDA graph (engine/graphs.py)
_HOST_OPS = ('aten.lift_fresh', 'aten._local_scalar_dense', 'aten.nonzero',
             'aten.masked_select', 'aten._unique', 'aten.unique',
             'aten.equal', 'aten.is_nonzero', 'aten.item')
_HOST_METHODS = ('tolist', 'numpy', 'cpu', 'item', '__bool__', '__float__',
                 '__int__', '__index__')


class HostSyncRecorder:
    """A CPU rehearsal of what a CUDA graph capture refuses: records, for
    the code run inside it, each tensor made from host data, each read
    of a tensor's value on the host and each op whose output shape
    depends on the data (boolean indexing, nonzero). ``found`` lists
    ``(what, file:line)`` of the innermost frame of the port. The range
    checks that ``F.one_hot`` with a class count makes on the CPU alone
    (on CUDA it relies on the scatter's device assert) are not
    recorded."""

    def __init__(self):
        self.found = []
        self._quiet = 0

    def _where(self):
        import traceback
        for frame in reversed(traceback.extract_stack()):
            if 'bpbreid_tpu_torch' in frame.filename:
                return '{}:{}'.format(
                    frame.filename.split('bpbreid_tpu_torch')[-1],
                    frame.lineno)
        return '?'

    def __enter__(self):
        from torch.overrides import TorchFunctionMode
        from torch.utils._python_dispatch import TorchDispatchMode
        rec = self

        class Functions(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                name = getattr(func, '__name__', '')
                kwargs = kwargs or {}
                if name in _HOST_METHODS and not rec._quiet:
                    rec.found.append((name, rec._where()))
                if name == 'one_hot' and (len(args) > 1 or 'num_classes'
                                          in kwargs):
                    rec._quiet += 1
                    try:
                        return func(*args, **kwargs)
                    finally:
                        rec._quiet -= 1
                return func(*args, **kwargs)

        class Dispatch(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                name = str(func)
                bool_index = name.startswith(('aten.index.', 'aten.index_put')) \
                    and any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                            for i in (args[1] if len(args) > 1 else ()) or ()
                            if i is not None)
                if (name.startswith(_HOST_OPS) or bool_index) \
                        and not rec._quiet:
                    rec.found.append((name, rec._where()))
                return func(*args, **(kwargs or {}))

        self._modes = [Functions(), Dispatch()]
        for m in self._modes:
            m.__enter__()
        return self

    def __exit__(self, *exc):
        for m in reversed(self._modes):
            m.__exit__(*exc)
        return False
