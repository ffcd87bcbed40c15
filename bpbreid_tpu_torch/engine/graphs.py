"""CUDA graphs of the engines' steps: the port's counterpart of JAX's
grouped dispatch, ``jax.jit`` of a ``lax.scan`` over k steps
(``train.steps_per_dispatch``, ``test.batches_per_dispatch``;
bpbreid_tpu/engine/part_based.py ``_train_multi_step_impl``,
``_eval_multi_step_impl``).

A step of the port launches thousands of kernels, and on the H100 the
host's time to launch them is most of a step (PERF.md, section 5). A
``GraphStep`` captures one call of a step function into a
``torch.cuda.CUDAGraph`` and replays it: one graph launch a step. Its
calls, in order, under one capture key:

- the first runs the step eagerly on the helper's side stream: a real
  step, and the warm-up of what a capture may not do (cuDNN's and
  cuBLAS's plans and workspaces on the capture's stream, the optimizer's
  state and gradients, the constants of ``ops.tensortools.constant``);
- the second copies its inputs into static buffers, captures the step on
  them (``capture_error_mode='thread_local'``: the prefetch thread may
  pin and copy meanwhile), then replays the graph;
- each later one copies its inputs into the buffers and replays.

So no step runs twice and none is skipped. The key is the inputs'
shapes and dtypes, the caller's ``key`` (each param group's lr and the
frozen-base flag in training, the ``QuantOpts`` in eval) and the
caller's ``state()``: where the tensors the step reads and writes lie (a
loaded optimizer state or a new gradient moves them; a graph reads them
by address). A new key drops the graph and starts again with an eager
step.

Each call returns clones of the step's outputs: the next replay
overwrites the graph's own. The engines' ``torch.Generator``\\ s are
registered with each graph (``register_generator_state``), so a replay
draws the numbers the eager step would draw and advances the generator
as far. Host counters do not move on a replay: the counts that a capture
added to each counter of ``REPLAYED_COUNTERS`` (``ops/cuda/build.py
launch_counts``, and any counter given to ``replayed_counter``) are taken
back after the capture and added again on every replay, so a launch
count counts the kernels that ran, eager or replayed. A capture or replay
that fails raises; nothing falls back to an eager step.

The step may only launch work on the current stream: no read of a
tensor's value on the host, no tensor made from host data (after its
first call), no output whose shape depends on the data.
"""
import contextlib

import torch

from bpbreid_tpu_torch.ops.cuda.build import launch_counts

__all__ = ['GraphStep', 'REPLAYED_COUNTERS', 'replayed_counter',
           'tensor_addresses']

REPLAYED_COUNTERS = [launch_counts]


@contextlib.contextmanager
def replayed_counter(counter):
    """Count replays into ``counter`` (a dict of numbers) too for the
    length of the block."""
    REPLAYED_COUNTERS.append(counter)
    try:
        yield counter
    finally:
        REPLAYED_COUNTERS.remove(counter)


def tensor_addresses(tensors, versions=False):
    """The addresses of ``tensors`` (None for a missing one), with each
    one's version counter when ``versions``: what a graph's key holds of
    the state it reads."""
    if versions:
        return tuple(None if t is None else (t.data_ptr(), t._version)
                     for t in tensors)
    return tuple(None if t is None else t.data_ptr() for t in tensors)


def _map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def _inputs_key(inputs):
    return tuple(None if t is None else (tuple(t.shape), t.dtype, t.device)
                 for t in inputs)


class GraphStep:
    """Calls of ``fn(*inputs)`` (tensors on one CUDA device, or None)
    through a CUDA graph; see the module docstring.

    Args:
        fn: the step; returns a tree (tuples, lists, dicts) of tensors.
        generators: the ``torch.Generator``\\ s ``fn`` draws from.
        state: a callable returning what the key holds of the state
            ``fn`` reads and writes (``tensor_addresses``), or None.

    ``eager_steps``, ``captures`` and ``replays`` count the calls of
    each kind.
    """

    def __init__(self, fn, generators=(), state=None):
        self.fn = fn
        self.generators = [g for g in generators
                           if g is not None and g.device.type == 'cuda']
        self.state = state or (lambda: None)
        self.key = None
        self.graph = self.static_in = self.static_out = None
        self.stream = None
        self.deltas = []
        self.eager_steps = self.captures = self.replays = 0

    def reset(self):
        """Drop the graph (and its memory pool) and the key."""
        self.key = None
        self.graph = self.static_in = self.static_out = None
        self.deltas = []

    def __call__(self, inputs, key=()):
        inputs = list(inputs)
        full_key = (_inputs_key(inputs), key, self.state())
        if full_key != self.key:
            self.reset()
            out = self._eager(inputs)
            self.key = (full_key[0], key, self.state())
            return out
        if self.graph is None:
            self._capture(inputs)
            self.key = (full_key[0], key, self.state())
        else:
            for dst, src in zip(self.static_in, inputs):
                if dst is not None:
                    dst.copy_(src)
        self.graph.replay()
        self.replays += 1
        for counter, delta in self.deltas:
            if any(counter is c for c in REPLAYED_COUNTERS):
                for name, n in delta.items():
                    counter[name] = counter.get(name, 0) + n
        return _map(torch.Tensor.clone, self.static_out)

    def _side_stream(self, device):
        if self.stream is None:
            self.stream = torch.cuda.Stream(device)
        return self.stream

    def _eager(self, inputs):
        device = next(t.device for t in inputs if t is not None)
        current = torch.cuda.current_stream(device)
        side = self._side_stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self.fn(*inputs)
        current.wait_stream(side)
        # the allocator must not hand out what either stream still uses
        for t in inputs:
            if t is not None:
                t.record_stream(side)
        _map(lambda t: t.record_stream(current), out)
        self.eager_steps += 1
        return out

    def _capture(self, inputs):
        device = next(t.device for t in inputs if t is not None)
        self.static_in = [None if t is None else t.clone() for t in inputs]
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        before = [dict(c) for c in REPLAYED_COUNTERS]
        with torch.cuda.graph(graph, stream=self._side_stream(device),
                              capture_error_mode='thread_local'):
            out = self.fn(*self.static_in)
        self.deltas = []
        for counter, was in zip(REPLAYED_COUNTERS, before):
            delta = {k: v - was.get(k, 0) for k, v in counter.items()
                     if v != was.get(k, 0)}
            for k, n in delta.items():
                counter[k] -= n
            self.deltas.append((counter, delta))
        self.graph, self.static_out = graph, out
        self.captures += 1
