"""``tiled_fwd_roofline``: the least time of the step's counted pairs
through the tiled kernels' forward, over the device time of every item
launched from ``dgs_tpu_torch/kernels/tiled.py`` in the forward,
whatever kernel or kernel mode it is, in %."""

from bench_port.metrics import _roofline


def read(ctx):
    return _roofline.share(ctx, "dgs_tpu_torch/kernels/tiled.py", False,
                           ())
