"""Spans of the port's own phases, recorded by ``torch.profiler``.

``span(name)`` is a context manager around one phase of the engine, its
CUDA graphs or its prefetch (``engine/engine.py``,
``engine/part_based.py``, ``engine/graphs.py``). While a profiler runs
(``utils.writer.ProfilerTrace``, or any ``torch.profiler.profile``) it
enters ``torch.profiler.record_function(name)``: the span is then a
``user_annotation`` event of the profiler's Chrome trace, on the thread
that entered it and on the same clock as the device's kernels (the
trace's ``ts`` in microseconds plus its ``baseTimeNanoseconds`` is
``time.time_ns()``). The profiler keeps the spans in memory and writes
them with the rest of its trace; nothing else records or exports them.
Readers: ``tools/profile_summary.py`` and the benchmark's metrics
(PERF.md, section 3).

With no profiler running, ``span`` reads one flag and returns a shared
no-op context (about 0.15 us); ``record_function`` itself costs 10 us or
more a call even then, so it is never entered unprofiled.

A span must open and close on one thread, with no ``yield`` inside it.
"""
import contextlib

from torch.autograd import profiler as _profiler
from torch.profiler import record_function

__all__ = ['span']

_OFF = contextlib.nullcontext()


def span(name):
    """A context manager that records ``name`` as a profiler span while a
    profiler runs, and does nothing otherwise."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return record_function(name)
