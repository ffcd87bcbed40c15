"""The plain references the program is judged against, one module a model.

A configuration file names its reference by an optional ``"reference"``
key: the module ``benchmark/reference/<name>.py``, ``"model"`` (BPBReID)
when the key is absent. ``reference_of`` resolves it; the counts
(``benchmark/counts.py``), the seeded weights (``benchmark/weights.py``)
and the traffic kinds take the model from it and from nowhere else.

A reference module gives:

- ``build(config, device)``: the model of the configuration on ``device``
  (``'meta'`` for the counts), its parameter and buffer names those of
  the program's ``state_dict``, so one seeded state dict loads into both;
- ``state_shapes(config)``: ``{name: shape}`` of that state dict;
- ``counting_loss(config, out, n, device)``: a train loss on the forward's
  output ``out`` for a batch of ``n``, whose gradient says which batch
  norms the backward reaches (``bn_roofline.train`` counts a backward
  only for those);
- ``feature_map(model)``, optional: the module whose output is the map
  the parts are pooled from (``k2_roofline.embed`` reads its shape);
  without it the counts have no map, and a cell of the model lists no
  metric that reads one;
- ``ends_residual(name, shapes)``, optional: whether the state-dict entry
  ``name`` is the scale of the last batch norm of a residual branch, which
  the seeded weights scale down (``benchmark/weights.py``; by default a
  ``bn3`` of a bottleneck, a ``bn2`` of a basic block).

It builds its batch norms, convolutions and linear layers from
``layers.py`` (``BN``, ``Conv``, ``Linear``, or ``conv2d`` and ``linear``
where it applies a weight itself): the counts find the batch norms by
that class, and only those products take the lower-precision control.
It imports nothing of the program under test and nothing of JAX.
"""
import re

__all__ = ['DEFAULT', 'reference_of']

DEFAULT = 'model'


def reference_of(config, root=None):
    """The reference module that ``config`` names (``benchmark/reference/
    <name>.py``). ``root``: the checkout whose files hold a reference the
    benchmark package lacks (the package's own by default)."""
    from benchmark.core import ROOT, load_module
    name = config.get('reference', DEFAULT)
    if not re.fullmatch(r'[A-Za-z_][A-Za-z0-9_]*', name):
        raise ValueError('the reference {!r} is no module name'.format(name))
    return load_module('reference', name, root or ROOT)
