"""graph_rebuilds.embed: the CUDA graph's eager steps and captures
an eval batch of the profiled stretch (the program's ``graph.eager`` and
``graph.capture`` spans over its steps): 0 while every call replays;
above 0 where the graph's key (the inputs' shapes, the caller's key, the
state's addresses) changed. Layer: the engine and its CUDA graphs
(``engine/graphs.py``)."""
from benchmark import spans


def read(ctx):
    return spans.graph_rebuilds(ctx.traced)
