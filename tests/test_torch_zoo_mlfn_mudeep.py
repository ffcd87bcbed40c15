"""MLFN (``models/mlfn.py``) and MuDeep (``models/mudeep.py``) of
bpbreid_tpu_torch against the JAX package's, each at full depth, and the
widths their part-based maps have.

Seeded JAX variables (BN affines, biases and statistics perturbed; MuDeep's
fusion gates too) cross over with ``load_jax_variables``; f32 on the CPU,
JAX jitted; eval to 1e-4 of the largest magnitude, train mode (outputs,
every running statistic after it) to 1e-3 and 1e-4:

- ``mlfn`` at 64x32 on 8 images of varied brightness and contrast
  (``zoo_images``): its factor-selection gates batch-normalize pooled
  vectors over the batch, which on a few near-alike images lets f32
  noise move the train output by a large share of its magnitude;
- ``mudeep`` at its fixed 256x128, batch 4 (its head reads 256 x 16 x 8
  values into 4096; the class scores in eval mode too, as in JAX).
"""
import importlib

import jax
import jax.numpy as jnp

from bpbreid_tpu.models.bpbreid import BPBreID as JBPBreID
from bpbreid_tpu_torch.models import mlfn as tmlfn
from bpbreid_tpu_torch.models import mudeep as tmudeep
from bpbreid_tpu_torch.models.bpbreid import BPBreID as TBPBreID
from tests.torch_port_helpers import check_zoo_model, limit_torch_threads

limit_torch_threads()

# the package's __init__ binds these names to the constructors
jmlfn = importlib.import_module('bpbreid_tpu.models.mlfn')
jmudeep = importlib.import_module('bpbreid_tpu.models.mudeep')


def test_mlfn_matches_jax():
    check_zoo_model('mlfn', (64, 32), n=8)


def test_mudeep_matches_jax():
    check_zoo_model('mudeep', (256, 128))


def _part_based_shapes(jm, hw):
    return jax.eval_shape(lambda: jm.init_with_output(
        jax.random.PRNGKey(0), jnp.zeros((1,) + hw + (3,)), train=False))


def test_mlfn_and_mudeep_part_based_width_divergence_kept_on_purpose():
    """JAX's ``MLFN.feature_dim`` (``bpbreid_tpu/models/mlfn.py`` :91)
    reports the embedding's 1024 while the part-based call returns the
    last block's 2048-channel map, and ``MuDeep.feature_dim`` (``mudeep.py``
    :42) the ``fc`` head's 4096 while it returns the 256-channel fused
    map; flax's shape inference hides both. The port's ``feature_dim`` is
    the map's width there (1024 and 4096 for the global models). With a
    ``before_pooling`` reduction to 1024 JAX's BPBReID keeps MLFN's
    2048-wide map where the port reduces it, and to 4096 JAX keeps
    MuDeep's 256-wide map where the port widens it; after pooling (every
    shipped config) they agree."""
    for jm, tm, tglobal, hw, j_dim, width in (
            (jmlfn.mlfn(7, loss='part_based'), tmlfn.mlfn(7, 'part_based'),
             tmlfn.mlfn(7), (64, 32), 1024, 2048),
            (jmudeep.mudeep(7, loss='part_based'),
             tmudeep.mudeep(7, 'part_based'), tmudeep.mudeep(7), (256, 128),
             4096, 256)):
        out, variables = _part_based_shapes(jm, hw)
        assert jm.feature_dim == j_dim and out.shape[-1] == width
        assert 'classifier' not in variables['params']
        assert tm.feature_dim == width and tglobal.feature_dim == j_dim
    for name, out_dim in (('mlfn', 1024), ('mudeep', 4096)):
        kw = dict(num_classes=7, parts_num=5, backbone=name,
                  dim_reduce='before_pooling', dim_reduce_output=out_dim)
        assert not JBPBreID(**kw).bind({}).use_before_reduce
        assert TBPBreID(**kw).use_before_reduce
