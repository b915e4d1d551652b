"""``glue_device_ms.*``: device ms a step of the items whose innermost span
of the program is the field's (``dgs::field``), the facade's
(``dgs::facade.*``) or the op glue's (``dgs::op.*``): launched in no
binning and no kernel span."""

from bench_port.metrics import _spans


def read(ctx):
    return ctx.device_ms_per_step(_spans.glue)
