"""Device time by kernel of the aggregation kernels' training step, or of
their structure build.

The counterpart of tools/profile_aggregate.py: tools.bench_aggregate's
cloud and parameter groups (AGG_P, AGG_L, AGG_K, AGG_NFREQ, AGG_SIGMA,
AGG_TILE, AGG_LADDER), the structure planned by ``plan_pallas`` (its plan
is the first line), then 5 steps under the profiler after 5 warm steps.
AGG_PROFILE=step (the default) profiles the forward + backward step with
every group moved by -1e-12 times its gradient; AGG_PROFILE=pre (or
preprocess, the JAX tool's word) profiles ``preprocess_pallas`` with each
build's means moved by the build before.  One JSON line a device item
({name, ms_per_step, calls, source}) and one a scope ({scope, ms_per_step,
items}, see tools.profile_step), the PROF_TOP (default 20, the JAX tool's
count) largest of each; none on the CPU.  The Chrome trace goes to PROF_DIR
when it is set, else to a temporary directory.

    python -m dgs_tpu_torch.tools.profile_aggregate

AGG_DEVICE (default cuda) picks the device.  AGG_BN / AGG_BE and the
other TPU-only knobs raise _common.UnsupportedKnob.
"""

from __future__ import annotations

import os

from . import _common, bench_aggregate

STEPS = 5


def settings(env=None) -> dict:
    env = os.environ if env is None else env
    s = bench_aggregate.settings(env)
    which = env.get("AGG_PROFILE", "step")
    if which not in ("step", "pre", "preprocess"):
        raise ValueError(f"AGG_PROFILE={which}: step or pre")
    return dict(s, method="pallas", which="step" if which == "step" else
                "pre", top=int(env.get("PROF_TOP", 20)),
                prof_dir=env.get("PROF_DIR"))


def run(s: dict) -> list:
    dev = _common.torch_device(s["device"], "AGG_DEVICE")
    st, nbr, build, train = bench_aggregate.steps(s, dev)
    card = _common.card(dev)
    records = [{"tool": "profile_aggregate", "plan": list(st.plan),
                "tile": st.cfg.tile_size, **card}]
    for _ in range(STEPS):
        train()
    fn = train if s["which"] == "step" else build
    ops, scopes, gaps = _common.profile_ops(fn, STEPS, s["top"],
                                            s["prof_dir"], dev)
    over = int(nbr.overflow) + (int(build().overflow)
                                if s["which"] == "pre" else 0)
    if over:
        raise RuntimeError(f"aggregation overflow: {over}")
    records += [{"tool": "profile_aggregate", "profile": s["which"], **r,
                 **card} for r in ops + scopes + gaps]
    return records


def main():
    _common.print_records(run(settings()))


if __name__ == "__main__":
    main()
