"""``eval_frames_per_s``: target frames whose label maps reached the host
in the window, over the window's wall time. Each video's encode of its
``videoLen`` copies of frame 0 counts in the time, not in the frames."""


def read(ctx):
    w = ctx.window
    return w["targets"] / w["wall_s"] if w["wall_s"] > 0 else None
