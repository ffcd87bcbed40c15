"""The program's spans in a profiled stretch: the ``user_annotation``
events that ``bpbreid_tpu_torch/utils/tracing.py`` records, which
``trace.Trace`` keeps among its host events (``Trace.host``). The span
names (``engine.*``, ``graph.*``, ``prefetch.*``) are the program's; no
profiled op has such a name. On a commit whose program records no spans
every function here returns None, as the readers built on them do."""

__all__ = ['intervals', 'span_ms', 'graph_host_ms', 'graph_rebuilds']

GRAPH_LAUNCH = ('cudaGraphLaunch',)


def intervals(trace, name):
    """``[(start, end)]`` in microseconds of the spans named ``name``."""
    return [(ts, ts + d) for n, ts, d in trace.host if n == name]


def _steps(trace):
    return trace.steps if trace is not None and trace.steps else None


def span_ms(trace, name):
    """Summed milliseconds of the spans named ``name`` a step (a train
    step or an eval batch) of the stretch; None without such a span."""
    found = intervals(trace, name) if _steps(trace) else []
    if not found:
        return None
    return sum(e - s for s, e in found) / trace.steps / 1e3


def graph_host_ms(trace):
    """Host milliseconds a step inside the CUDA graph's calls
    (``graph.step``) less the ``cudaGraphLaunch*`` API time inside them;
    None without ``graph.step`` spans."""
    calls = intervals(trace, 'graph.step') if _steps(trace) else []
    if not calls:
        return None
    launch_us = sum(d for name, ts, d in trace.api
                    if name.startswith(GRAPH_LAUNCH)
                    and any(s <= ts and ts + d <= e for s, e in calls))
    return (sum(e - s for s, e in calls) - launch_us) / trace.steps / 1e3


def graph_rebuilds(trace):
    """The CUDA graph's eager steps and captures (``graph.eager`` and
    ``graph.capture`` spans) a step; None without ``graph.step``
    spans."""
    if not _steps(trace) or not intervals(trace, 'graph.step'):
        return None
    return (len(intervals(trace, 'graph.eager'))
            + len(intervals(trace, 'graph.capture'))) / trace.steps
