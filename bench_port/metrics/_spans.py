"""The span readers' selection: a device item of the stack pass belongs to
the innermost of the program's ``dgs::`` spans (``record_function``
annotations, among the host ops open at its launch) around it; items
launched under no such span belong to none."""

PREFIX = "dgs::"


def innermost(it):
    """The name of the innermost ``dgs::`` span open at the item's launch,
    or None."""
    for op in reversed(it.ops):
        if op.startswith(PREFIX):
            return op
    return None


def binning(it) -> bool:
    """Launched inside the binning's spans (``dgs::binning`` and its
    children)."""
    name = innermost(it)
    return name is not None and name.startswith("dgs::binning")


def glue(it) -> bool:
    """Launched with a span of the field, the facade or the op glue
    innermost: in no binning and no kernel span."""
    name = innermost(it)
    return name is not None and (name == "dgs::field" or name.startswith(
        ("dgs::facade.", "dgs::op.")))


def launches_per_step(ctx, select):
    """Device items a step of the stack pass that ``select`` keeps; None
    where it keeps none."""
    n = sum(1 for it in ctx.attributed if select(it))
    return n / ctx.stack_steps if n else None
