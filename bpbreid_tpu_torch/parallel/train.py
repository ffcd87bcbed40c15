"""Data-parallel distribution of an engine (port of
bpbreid_tpu/parallel/train.py).

JAX re-jits the engine's train step with the batch sharded over the
``data`` mesh and lets XLA insert the reductions; the sharded step sees
the global batch. The port keeps those semantics with one process per
device, each rank holding the same replicated model:

- every rank loads the global batch, draws the global batch's
  augmentation from its seeded generator (so the generators stay in
  lockstep) and runs the model on its slice;
- train-mode batch norm takes its statistics over every rank's samples
  (``models.common.FastBatchNorm``: the sums of ``bn_stats`` all-reduced,
  then ``bn_apply_sums`` with the global count; backward, a copy of the
  sums of ``bn_grad_stats`` all-reduced before ``bn_dx``), and the running
  statistics move by the global statistics on every rank;
- the outputs are gathered (the rank's own slice live), so batch-hard
  triplet mining, the cross entropy and BPA run over the global batch;
- the parameter gradients are summed over the ranks before the
  optimizer step (``Engine.optimizer_step``): the one-process gradient;
- rank 0 alone keeps the writer and writes checkpoints and figures.

This is not ``DistributedDataParallel``, whose replicas normalize and
mine over their own slice only.
"""
from bpbreid_tpu_torch.parallel.mesh import make_mesh, replicate

__all__ = ['distribute_engine']


def distribute_engine(engine, mesh=None, n_devices=None):
    """Make ``engine`` one rank of a data-parallel step.

    Args:
        engine: a part-based, image or video engine (``engine.model`` on
            this rank's device).
        mesh: a ``Mesh``; built over the initialized process group
            (``n_devices`` ranks) if None.
    Returns:
        the mesh.
    """
    # models.common reads parallel.mesh: imported here, not at the top
    from bpbreid_tpu_torch.models.common import (FastBatchNorm,
                                                 GeneratorDropout)
    mesh = mesh or make_mesh(n_devices)
    engine.mesh = mesh
    if mesh.rank != 0:
        # rank 0 alone writes the scalars and figures
        engine.writer = None
    for m in engine.model.modules():
        if isinstance(m, (FastBatchNorm, GeneratorDropout)):
            m.mesh = mesh
    replicate(mesh, engine.model)
    return mesh
