"""``dense_bwd_roofline``: the least time of the step's counted pairs
through the dense kernels' backward, over the device time of every item
launched from ``dgs_tpu_torch/kernels/dense.py`` in the backward,
whatever kernel or kernel mode it is, in %."""

from bench_port.metrics import _roofline


def read(ctx):
    return _roofline.share(ctx, "dgs_tpu_torch/kernels/dense.py", True,
                           ())
