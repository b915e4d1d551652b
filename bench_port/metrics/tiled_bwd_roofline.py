"""``tiled_bwd_roofline``: the least time of the step's counted pairs
through the tiled kernels' backward, over the device time of every item
launched from ``dgs_tpu_torch/kernels/tiled.py`` in the backward (the segment-sum, launched from
``kernels/segment.py``, left out),
whatever kernel or kernel mode it is, in %."""

from bench_port.metrics import _roofline


def read(ctx):
    return _roofline.share(ctx, "dgs_tpu_torch/kernels/tiled.py", True,
                           ("dgs_tpu_torch/kernels/segment.py",))
