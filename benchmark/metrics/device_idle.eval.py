"""``device_idle.eval``: the share of the traced video's wall window in
which no operation runs on the device (the union of the kernels', copies'
and sets' intervals), in %. Read from the pass profiled without the
host's operators, whose recording would slow the host and so inflate the
idle share."""


def read(ctx):
    t = ctx.window.get("idle_trace")
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
