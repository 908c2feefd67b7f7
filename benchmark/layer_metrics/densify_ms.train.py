"""ms a window step of optim.densify through train_lib.densify_cadence: the
benchmark's own synchronised span around each densify call in the traced
run's window, summed, over the window's steps; None when no round ran."""


def read(ctx):
    s = ctx.get("densify_s", 0.0)
    return 1e3 * s if s > 0 else None
