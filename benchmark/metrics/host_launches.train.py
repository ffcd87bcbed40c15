"""host_launches.train: the host's kernel and graph launch calls a train
step (``cudaLaunchKernel*``, ``cuLaunchKernel*``, ``cudaGraphLaunch*`` in
the profiled stretch, over its steps). Layer: the engine and its CUDA
graphs (``engine/engine.py``, ``engine/graphs.py``)."""
LAUNCH_CALLS = ('cudaLaunchKernel', 'cuLaunchKernel', 'cudaGraphLaunch')


def read(ctx):
    t = ctx.traced
    if t is None or not t.steps or not t.device:
        return None
    return t.api_calls(LAUNCH_CALLS) / t.steps
