"""Faults planted underneath the timed path, for showing that ``correct``
catches them (the CPU tests, and ``calibrate.py --fault`` on the card to
read them at a cell's own size).  Each is ``fault(system, loop)``, called
after set-up builds the program and before its first step."""

from __future__ import annotations

import torch


def unchanged(system, loop):
    """A step that returns its state unchanged: the update is computed and
    then undone, so no parameter moves."""
    inner = loop.opt.step

    def step(*a, **k):
        keep = [p.detach().clone() for p in loop.params]
        inner(*a, **k)
        with torch.no_grad():
            for p, v in zip(loop.params, keep):
                p.copy_(v)

    loop.opt.step = step


def half_batch(system, loop):
    """Half of the samples left out, the mean taken over the rest."""
    N = system.N
    if hasattr(system, "sc"):          # the chunked path
        inner = system.sc.sample_chunked

        class Half:
            def __getattr__(self, k):
                return getattr(system.sc, k)

            @staticmethod
            def sample_chunked(*a, **k):
                outs, diag = inner(*a, **k)
                cut = {}
                for o, v in outs.items():
                    keep = torch.ones_like(v)
                    if k.get("padded_outputs"):    # tile-sorted columns
                        keep[..., v.shape[-1] // 2:] = 0
                    else:
                        keep[N // 2:] = 0
                    cut[o] = v * keep
                return cut, diag

        system.sc = Half()
    else:                              # the all-pairs facade
        inner = system.sampler.sample_all

        def sample_all(orders):
            outs = inner(orders)
            return {o: torch.cat([v[:N // 2], 0 * v[N // 2:]])
                    for o, v in outs.items()}

        system.sampler.sample_all = sample_all
    system.N = N // 2


def altered(system, loop):
    """One answer altered where it is produced: one output component at
    one sample, by a hundredth of that order's largest magnitude."""
    inner = system.evaluate

    def evaluate(values, orders):
        outs, over = inner(values, orders)
        outs = dict(outs)
        o = orders[-1]
        v = outs[o].clone()
        flat = v.view(-1)
        flat[len(flat) // 3] += 0.01 * v.abs().max()
        outs[o] = v
        return outs, over

    system.evaluate = evaluate


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered": altered}
