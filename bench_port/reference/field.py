"""The reference's evaluation and training of a configuration: outputs at
chosen samples, and the first training steps with Adam, over the pairs the
configuration's rule keeps (``rules/<pair_rule>.py``).

All of it recomputes from the parameters and samples the benchmark made:
conics, radii, the pair rule, the outputs and the gradients (autograd
through the plain mathematics of ``gaussians.py``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple, Optional

import torch

from . import gaussians, pairs, rules
from .rules import Groups

LEAVES = ("means", "log_scales", "rotations", "values")


@contextlib.contextmanager
def exact_products():
    """float32 and float64 products without TF32 for the body (the
    lower-precision control rounds its operands itself)."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def rule(config: dict):
    """The configuration's pair rule, ``rules/<pair_rule>.py``."""
    return rules.load(config["pair_rule"])


def _batches(G: Groups, budget: int):
    """Runs of consecutive groups whose padded blocks hold at most
    ``budget`` pairs (a group alone may exceed it)."""
    n = len(G.s_ptr) - 1
    if G.shared:
        for g in range(n):
            yield [g]
        return
    run, smax, emax = [], 0, 0
    for g in range(n):
        S = G.s_ptr[g + 1] - G.s_ptr[g]
        E = G.e_ptr[g + 1] - G.e_ptr[g]
        if S == 0 or E == 0:
            continue
        s2, e2 = max(smax, S), max(emax, E)
        if run and (len(run) + 1) * s2 * e2 > budget:
            yield run
            run, s2, e2 = [], S, E
        run.append(g)
        smax, emax = s2, e2
    if run:
        yield run


def _block(G: Groups, run, dev):
    """Padded index blocks (s (B, S), s mask, e (B, E), e mask) of a run."""
    shared = G.shared
    s0 = torch.tensor([G.s_ptr[g] for g in run], device=dev)
    sn = torch.tensor([G.s_ptr[g + 1] - G.s_ptr[g] for g in run], device=dev)
    e0 = torch.tensor([0 if shared else G.e_ptr[g] for g in run], device=dev)
    en = torch.tensor([G.e_ptr[-1] if shared else G.e_ptr[g + 1] - G.e_ptr[g]
                       for g in run], device=dev)
    S, E = int(sn.max()), int(en.max())
    sa = torch.arange(S, device=dev)[None, :]
    ea = torch.arange(E, device=dev)[None, :]
    smask, emask = sa < sn[:, None], ea < en[:, None]
    s = G.s_idx[torch.where(smask, s0[:, None] + sa, 0)]
    e = G.e_idx[torch.where(emask, e0[:, None] + ea, 0)]
    return s, smask, e, emask


def outputs(config: dict, orders, geometry, values, samples, which,
            plan=None, dtype=torch.float64, budget: int = 1 << 23,
            tf32: bool = False) -> Dict[str, torch.Tensor]:
    """Every order's full tensor at the samples ``which`` (M,), in that
    order: the field of float32 geometry and ``values``, computed in
    ``dtype``; ``plan`` is the rule's (worked out from ``geometry`` where
    None)."""
    dev = samples.device
    D = config["D"]
    means, ls, rot = geometry
    r = rule(config)
    if plan is None:
        plan = r.plan(config, geometry)
    G = r.groups(config, plan, geometry, samples, which, budget)
    mu, val = means.to(dtype), values.to(dtype)
    con = pairs.conics(ls.to(dtype), rot.to(dtype))
    x = samples.to(dtype)
    K = sum(len(gaussians.sym_indices(o, D)) for o in orders)
    comps = torch.zeros((G.s_idx.shape[0], K, values.shape[1]), dtype=dtype,
                        device=dev)
    pos = torch.empty(samples.shape[0], dtype=torch.long, device=dev)
    pos[G.s_idx] = torch.arange(G.s_idx.shape[0], device=dev)
    with torch.no_grad(), exact_products():
        for run in _batches(G, budget):
            s, sm, e, em = _block(G, run, dev)
            out = gaussians.evaluate(orders, x[s], sm, mu[e], con[e],
                                     val[e], em, config["period"], tf32)
            comps[pos[s[sm]]] = out[sm]
    order = pos[which] if which is not None else pos
    return gaussians.unpack(orders, D, comps[order])


class TrainReadings(NamedTuple):
    losses: List[float]                 # loss of each step
    grads: Dict[str, float]             # norm of each leaf's first gradient


def train(config: dict, orders, init: Dict[str, torch.Tensor], samples,
          lr: float, betas, eps: float, steps: int,
          dtype=torch.float64, budget: int = 1 << 22,
          tf32: bool = False, record: Optional[dict] = None
          ) -> TrainReadings:
    """``steps`` training steps from the float32 parameters ``init``: the
    loss sum over orders of the full tensors' squares over the N samples,
    divided by N; its gradient by autograd; Adam (``lr``, ``betas``,
    ``eps``, no weight decay) on the four leaves, in ``dtype``, each new
    parameter rounded to float32 as the configuration stores it.
    ``record``, where given, receives the first gradients and the last
    parameters element by element (for looking into a reading)."""
    dev = samples.device
    N = samples.shape[0]
    p = {k: init[k].to(dtype).clone() for k in LEAVES}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    r = rule(config)
    plan = r.plan(config, tuple(init[k] for k in LEAVES[:3]))
    w = gaussians.loss_weights(orders, config["D"], dtype, dev)
    x = samples.to(dtype)
    losses, grads = [], None
    b1, b2 = betas
    for t in range(1, steps + 1):
        geometry = tuple(p[k].to(torch.float32) for k in LEAVES[:3])
        G = r.groups(config, plan, geometry, samples, None, budget)
        leaf = {k: p[k].detach().clone().requires_grad_() for k in LEAVES}
        con = pairs.conics(leaf["log_scales"], leaf["rotations"])
        con_d = con.detach().requires_grad_()
        total = torch.zeros((), dtype=dtype, device=dev)
        with exact_products():
            for run in _batches(G, budget):
                s, sm, e, em = _block(G, run, dev)
                out = gaussians.evaluate(
                    orders, x[s], sm, leaf["means"][e], con_d[e],
                    leaf["values"][e], em, config["period"], tf32)
                lb = (out * out * w[None, None, :, None]).sum() / N
                lb.backward()
                total += lb.detach()
        con.backward(con_d.grad)
        g = {k: leaf[k].grad for k in LEAVES}
        losses.append(float(total))
        if t == 1:
            grads = {k: float(torch.linalg.vector_norm(g[k])) for k in LEAVES}
            if record is not None:
                record["grads"] = {k: g[k].detach().clone() for k in LEAVES}
        with torch.no_grad():
            for k in LEAVES:
                m[k].mul_(b1).add_(g[k], alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g[k], g[k], value=1 - b2)
                mh = m[k] / (1 - b1 ** t)
                vh = v2[k] / (1 - b2 ** t)
                # The parameters are float32: the exact update, rounded
                # once to the nearest float32.
                p[k] = (p[k] - lr * mh / (vh.sqrt() + eps)).to(
                    torch.float32).to(dtype)
    if record is not None:
        record["params"] = p
    return TrainReadings(losses, grads)
