"""``device_idle_pct.train`` / ``.eval``: the share of an untraced step's
time in which no kernel, copy or set ran on the device: 1 - the traced
pass's busy time a step (the union of the device's intervals) over the
untraced window's time a step, in %.  The traced pass's own window is
longer, as the profiler slows the host that launches the work."""


def read(ctx):
    if not ctx.items:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.steps / ctx.step_s)
