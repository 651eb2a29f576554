"""``train_clips_per_s``: every clip stepped in the window (the global
batch each step) over the window's wall time, which ends at the
synchronize that fetches the last step's loss."""


def read(ctx):
    w = ctx.window
    return w["clips"] / w["wall_s"] if w["wall_s"] > 0 else None
