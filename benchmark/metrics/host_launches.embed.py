"""host_launches.embed: the host's kernel and graph launch calls an eval
batch of a request (``cudaLaunchKernel*``, ``cuLaunchKernel*``,
``cudaGraphLaunch*`` in the profiled stretch, over its batches). Layer:
the engine and its CUDA graphs (``engine/part_based.py``,
``engine/graphs.py``)."""
LAUNCH_CALLS = ('cudaLaunchKernel', 'cuLaunchKernel', 'cudaGraphLaunch')


def read(ctx):
    t = ctx.traced
    if t is None or not t.steps or not t.device:
        return None
    return t.api_calls(LAUNCH_CALLS) / t.steps
