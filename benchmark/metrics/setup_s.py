"""``setup_s``: host seconds from the process's start to the window's
start: imports, reaching the card, the kernel libraries (built on the
checkout's first run, loaded after), the model and its seeded weights,
the inputs, the recorded first steps and the warm-up."""


def read(ctx):
    return ctx.setup_s
