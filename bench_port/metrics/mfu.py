"""``mfu.train`` / ``mfu.eval``: the step's least fp32 work (the
benchmark's pair count times the yardstick's instructions a pair, forward,
and for a train mix backward too) over the untraced window's time a step
at the card's fp32 peak, in %."""

from bench_port import yardstick


def read(ctx):
    cfg, w = ctx.config, ctx.work
    ops = yardstick.step_ops(w["pairs"], cfg["D"], ctx.traffic["orders"],
                             cfg["C"], w["wrapped"], ctx.kind == "train")
    return 100.0 * ops / (ctx.step_s * yardstick.FP32_INSTR_S)
