"""prefetch_wait_ms.embed: host milliseconds an eval batch in which the
engine waits for its prefetched batch: the program's ``prefetch.wait``
spans of ``device_prefetch`` (the worker's future, the copy's event,
``record_stream``), summed over the profiled requests, over their
batches. The worker thread's pinning and copy show only through this
wait. Layer: the engine and its CUDA graphs (``engine/engine.py``)."""
from benchmark import spans


def read(ctx):
    return spans.span_ms(ctx.traced, 'prefetch.wait')
