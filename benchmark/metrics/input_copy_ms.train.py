"""input_copy_ms.train: host milliseconds a train step in the group's
copy to the device: the program's ``engine.train_inputs`` spans, summed
over the profiled stretch, over its steps (the blocking ``.to()`` of
each group in ``forward_backward_multi``, which also waits for the
previous group's replays). Layer: the engine and its CUDA graphs
(``engine/engine.py``, ``engine/part_based.py``)."""
from benchmark import spans


def read(ctx):
    return spans.span_ms(ctx.traced, 'engine.train_inputs')
