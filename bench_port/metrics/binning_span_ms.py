"""``binning_span_ms.train`` / ``.eval``: device ms a step of the items
launched inside the program's binning spans (``dgs::binning`` and its
children ``.rects``, ``.cull``, ``.sort``, ``.shift``, ``.geometry``): the
in-program counterpart of ``binning_device_ms``, which attributes by the
Python stack."""

from bench_port.metrics import _spans


def read(ctx):
    return ctx.device_ms_per_step(_spans.binning)
