"""graph_host_ms.train: host milliseconds a train step inside the CUDA
graph's calls and outside their launches: the program's ``graph.step``
spans (the key, the copy into the static inputs, the replay's counters,
the outputs' clones; an eager step or a capture where one runs) less the
``cudaGraphLaunch*`` API time inside them, over the profiled stretch's
steps. Layer: the engine and its CUDA graphs (``engine/graphs.py``)."""
from benchmark import spans


def read(ctx):
    return spans.graph_host_ms(ctx.traced)
