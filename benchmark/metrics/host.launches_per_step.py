"""``host.launches_per_step``: the host's kernel launch calls a training
step (``cudaLaunchKernel``, ``cuLaunchKernel`` and their variants, and
graph launches) among the profiler's CPU events of the traced stretch.
A count: it repeats exactly from run to run."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.launches:
        return None
    return len(ctx.trace.launches) / ctx.window["trace_steps"]
