"""``host_syncs.*``: host-blocking synchronisations the program made per
top-level call (``sync.*`` over ``calls.*`` of the program's counters,
which count while the traced passes run), so the value does not depend on
how many traced steps counted.  None where the stack pass launched no
device item inside a span of the program (a program without spans and
counters, or a pass with no device), or where no call was counted."""

from bench_port.metrics import _spans


def read(ctx):
    from dgs_tpu_torch.utils import profiling

    counters = getattr(profiling, "counters", None)
    if counters is None or not any(_spans.innermost(it)
                                   for it in ctx.attributed):
        return None
    got = counters()
    calls = sum(v for k, v in got.items() if k.startswith("calls."))
    if not calls:
        return None
    return sum(v for k, v in got.items() if k.startswith("sync.")) / calls
