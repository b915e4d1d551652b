"""``launches_per_step.train`` / ``.eval``: device items (kernels, copies,
sets) a step or request in the traced window: the host's dispatch work."""


def read(ctx):
    if not ctx.items:
        return None
    return len(ctx.items) / ctx.steps
