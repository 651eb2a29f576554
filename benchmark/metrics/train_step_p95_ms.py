"""``train_step_p95_ms``: the 95th percentile of every step period of the
window, from an event recorded at each step's start on the step's stream
(the last period ends at an event after the last step), read after the
window: a tail of all steps, at no sync a step."""

from harness.common import quantile


def read(ctx):
    periods = ctx.window["periods_ms"]
    return quantile(periods, 0.95) if periods else None
