"""The share of a roofline shared by the kernel-layer readers: the least
time of the benchmark's counted work (``yardstick.kernel_bound_s``) over
the device time of every item launched from one file of the program's
kernels, in the forward (launched outside autograd's engine) or in the
backward (launched by an autograd node), in %."""

from bench_port import yardstick

BACKWARD = "autograd::engine::evaluate_function"


def select(source: str, backward: bool, exclude=()):
    def keep(it):
        if not any(source in f for f in it.frames):
            return False
        if any(x in f for f in it.frames for x in exclude):
            return False
        return any(o.startswith(BACKWARD) for o in it.ops) == backward
    return keep


def share(ctx, source: str, backward: bool, exclude=()):
    ms = ctx.device_ms_per_step(select(source, backward, exclude))
    if ms is None:
        return None
    cfg, w = ctx.config, ctx.work
    orders = ctx.traffic["orders"]
    moved = yardstick.moved_floats(cfg["D"], orders, cfg["C"], w["entries"],
                                   cfg["N"], backward)
    bound_s = yardstick.kernel_bound_s(w["pairs"], moved, cfg["D"], orders,
                                       cfg["C"], w["wrapped"], backward)
    return 100.0 * bound_s * 1e3 / ms
