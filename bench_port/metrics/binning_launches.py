"""``binning_launches.train`` / ``.eval``: device items (kernels, copies,
sets) a step launched inside the program's binning spans."""

from bench_port.metrics import _spans


def read(ctx):
    return _spans.launches_per_step(ctx, _spans.binning)
