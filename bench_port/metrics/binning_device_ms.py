"""``binning_device_ms.train`` / ``.eval``: device ms a step of the items
launched from the program's binning (``dgs_tpu_torch/binning/``: the
Gaussians' entries, the ellipsoid cull, the sort, the range geometry),
attributed by the launching thread's Python stack."""

LAYER = "dgs_tpu_torch/binning/"


def read(ctx):
    return ctx.device_ms_per_step(
        lambda it: any(LAYER in f for f in it.frames))
