"""``glue_launches.*``: device items (kernels, copies, sets) a step whose
innermost span of the program is the field's, the facade's or the op
glue's."""

from bench_port.metrics import _spans


def read(ctx):
    return _spans.launches_per_step(ctx, _spans.glue)
