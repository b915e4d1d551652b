"""dgs_tpu_torch's kernel aggregation path (plan_pallas, preprocess_pallas,
the plain versions of the totals / forward / backward kernels,
aggregate_pallas and its hand-wired backward) against dgs_tpu's, whose
Pallas kernels run in interpret mode, on the same seeded numpy inputs.
Twin of tests/test_aggregation_pallas.py.  The two structures differ in
layout (dgs_tpu pads each tile to chunks), so results are compared in
Gaussian order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgs_tpu.config import SamplerConfig as JConfig
from dgs_tpu.kernels import aggregate as jkagg
from dgs_tpu.oracle.dense import radii as jradii
from dgs_tpu.ops import aggregation as jagg
from dgs_tpu_torch.binning import grid as tgrid
from dgs_tpu_torch.config import SamplerConfig as TConfig
from dgs_tpu_torch.kernels import aggregate as tkagg
from dgs_tpu_torch.ops import aggregation as tagg

from conftest import make_gaussians
from test_torch_aggregation import (GROUPS, assert_grads_close,
                                    assert_out_close, jnp_all,
                                    outputs_and_grads, torch_all)

torch.set_num_threads(2)

OPEN = dict(period=None, lower=(-1.0, -1.0), upper_bounds=(1.0, 1.0))


def make_inputs(rng, P, D, L, K, nfreq, sigma_range=(0.05, 0.25), cull=0):
    """The JAX twin's inputs (test_aggregation_pallas.py:24-39): (means,
    conics, radii, params) as numpy arrays."""
    means, _, covs, conics = make_gaussians(rng, P, D, L,
                                            sigma_range=sigma_range)
    E = 2 * D * nfreq + 1
    params = dict(
        features=rng.normal(0.0, 1.0, (P, L)),
        transform=rng.normal(0.0, 0.3, (L, L)),
        queries=rng.normal(0.0, 1.0, (P, K)),
        keys=rng.normal(0.0, 1.0, (P, K)),
        frequencies=np.abs(rng.normal(0.0, 1.0, (nfreq,))) + 0.5,
        distance_transform=rng.normal(0.0, 0.5, (2 * E,)))
    radii = np.array(jradii(jnp.asarray(covs), D, 3.0, 1e-12))
    if cull:
        radii[::cull] = 0.0
    return means, conics, radii, {k: v.astype(np.float32)
                                  for k, v in params.items()}


def chunk_counts(starts, block):
    """(T,) chunks of ``block`` rows per tile for tile-sorted rows with the
    range table ``starts`` ((T+2,))."""
    T = starts.shape[0] - 2
    n = (starts[1:T + 1] - starts[:T]).numpy().astype(np.int64)
    return -(-n // block)


def tpu_plan(tc, means, radii, tplan, block_n=32, block_e=128):
    """The port's plan as a dgs_tpu AggPlan tuple: (rect, entries) and the
    TPU layout's chunk and work counts at ``block_n`` / ``block_e``
    (e_chunks, c_chunks, work_fwd, work_bwd), counted on the port's own
    geometry build."""
    m, r = torch_all(means, radii)
    P, D = m.shape
    _, rho = tagg._collision_geometry(r)
    start = tgrid.duplicate_entries(tc, m, rho, tplan.rect,
                                    P * tplan.rect ** D)[2]
    em = chunk_counts(start, block_e)
    cm = chunk_counts(tgrid.bin_samples(tc, m).s_start, block_n)
    return (tplan.rect, tplan.entries, max(int(em.sum()), 1),
            max(int(cm.sum()), 1),
            max(int((cm * np.maximum(em, 1)).sum()), 1),
            max(int((em * np.maximum(cm, 1)).sum()), 1))


def structures(means, conics, radii, D, cfg_kw=None, **kw):
    """(dgs_tpu AggBinning, port AggBinning) over the same inputs, the
    plans asserted equal."""
    cfg_kw = cfg_kw or {}
    jc, jplan = jagg.plan_pallas(JConfig(**cfg_kw).with_dims(D),
                                 *jnp_all(means, radii), block_n=16)
    tc, tplan = tagg.plan_pallas(TConfig(**cfg_kw).with_dims(D),
                                 *torch_all(means, radii), block_n=16)
    assert tplan._fields == jplan._fields[:2]
    assert tpu_plan(tc, means, radii, tplan, block_n=16) == tuple(jplan)
    assert tc.tile_size == jc.tile_size
    ja = jagg.preprocess_pallas(jc, *jnp_all(means, conics, radii), jplan,
                                16, 128, **kw)
    ta = tagg.preprocess_pallas(tc, *torch_all(means, conics, radii), tplan,
                                16, 128, **kw)
    assert int(ja.overflow) == 0 and int(ta.overflow) == 0
    return ja, ta


@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("cfg_kw", [{}, OPEN], ids=["torus", "open"])
def test_plan_pallas_matches(rng, D, cfg_kw):
    means, _, radii, _ = make_inputs(rng, 150, D, 1, 1, 1, cull=7)
    for blocks in (dict(), dict(block_n=16, block_e=128),
                   dict(block_n=8, block_e=256), dict(auto_tile=False)):
        jc, jplan = jagg.plan_pallas(JConfig(**cfg_kw).with_dims(D),
                                     *jnp_all(means, radii), **blocks)
        tc, tplan = tagg.plan_pallas(TConfig(**cfg_kw).with_dims(D),
                                     *torch_all(means, radii), **blocks)
        assert tpu_plan(tc, means, radii, tplan, blocks.get("block_n", 32),
                        blocks.get("block_e", 128)) == tuple(jplan), blocks
        assert tc.tile_size == jc.tile_size
        assert tc.grid_shape() == jc.grid_shape()


@pytest.mark.parametrize("D", [1, 2, 3])
def test_preprocess_pallas_structure_matches(rng, D):
    """The structure's contract: the same valid entries, inv_norm and
    inv_tot per centre through ``pos``, a consistent cid / pos pair, ranges
    that are each row's own tile, overflow 0."""
    P = 150
    means, conics, radii, _ = make_inputs(rng, P, D, 1, 1, 1, cull=7)
    ja, ta = structures(means, conics, radii, D)
    jgid, tgid = np.asarray(ja.ent_gid), ta.ent_gid.numpy()
    np.testing.assert_array_equal(np.sort(tgid[tgid < P]),
                                  np.sort(jgid[jgid < P]))
    jpos, tpos = np.asarray(ja.pos), ta.pos.numpy()
    np.testing.assert_array_equal(ta.cid.numpy()[tpos], np.arange(P))
    # Centre rows (mean, r_eff, inv_norm exactly; inv_tot within the two
    # frameworks' exp and sum order).
    jrow, trow = np.asarray(ja.ctr_static)[jpos], ta.ctr_static.numpy()[tpos]
    np.testing.assert_allclose(trow[:, :D + 2], jrow[:, :D + 2], rtol=1e-6)
    np.testing.assert_allclose(trow[:, D + 2], jrow[:, D + 2], rtol=1e-5)
    # Entry rows: the same multiset of (gid, shifted mean, conic, radius).
    def rows(gid, geo):
        r = np.concatenate([gid[:, None].astype(np.float64), geo.T], axis=1)
        r = r[gid < P]
        return r[np.lexsort(r.T[::-1])]
    np.testing.assert_allclose(rows(tgid, ta.ent_geo.numpy()),
                               rows(jgid, np.asarray(ja.ent_geo)),
                               rtol=1e-6, atol=1e-6)
    # Sentinel rows are zero with empty ranges.
    assert not ta.ent_geo.numpy()[:, tgid == P].any()
    assert not ta.ctr_static.numpy()[ta.cid.numpy() == P, :D + 2].any()
    lo, hi = ta.ctr_ent.numpy()
    assert ((hi - lo)[ta.cid.numpy() == P] == 0).all()
    # compute_totals=False leaves the inv_tot column at 1.
    _, tf = structures(means, conics, radii, D, compute_totals=False)
    assert (tf.ctr_static[:, D + 2] == 1.0).all()
    # The structure carried across as numpy arrays.
    back = tagg.AggBinning.from_numpy(
        *[a.numpy() for a in ta[:8]], ta.rect, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(back[:8], ta[:8]))
    assert back.rect == ta.rect


def jax_operands(params, agg, nfreq):
    """dgs_tpu's kernel operands (aggregate_pallas's _gather)."""
    f, q, k = (jnp.asarray(params[n]) for n in ("features", "queries", "keys"))
    L, K = f.shape[1], q.shape[1]
    fk = jnp.concatenate([f, k], axis=1)
    fk = jnp.concatenate([fk, jnp.zeros((1, L + K), fk.dtype)], 0)
    ent_fk = fk[agg.ent_gid].T
    q_tab = jnp.concatenate([q, jnp.zeros((1, K), q.dtype)])
    ctr_geo = jnp.concatenate([agg.ctr_static, q_tab[agg.cid]], axis=1)
    dtf = jnp.concatenate([jnp.asarray(params["distance_transform"]),
                           jnp.asarray(params["frequencies"])[:nfreq]])[None]
    return ent_fk, ctr_geo, dtf


def by_gaussian(rows, gid, P):
    """(P, F) sums of per-entry columns (F, E) by Gaussian id."""
    out = np.zeros((P + 1, rows.shape[0]), np.float64)
    np.add.at(out, gid, rows.T)
    return out[:P]


@pytest.mark.parametrize("ladder", [False, True])
@pytest.mark.parametrize("D", [1, 2, 3])
def test_plain_kernels_match_jax_kernels(rng, D, ladder):
    """totals_plain, forward_plain (with and without totals) and
    backward_plain against dgs_tpu's three kernels, each on its own
    package's structure and operands, mapped to Gaussian order.  Forward
    quantities within rtol 2e-4, backward within rtol 2e-3 (the JAX
    suite's kernel tolerances)."""
    P, L, K, nfreq = 90, 5, 3, 2
    means, conics, radii, params = make_inputs(rng, P, D, L, K, nfreq, cull=7)
    if ladder:
        params["frequencies"] = (0.83 * np.arange(1, nfreq + 1)).astype(
            np.float32)
    ja, ta = structures(means, conics, radii, D)
    jpos, tpos = np.asarray(ja.pos), ta.pos.numpy()
    E = 2 * D * nfreq + 1

    j_fk, j_ctr, j_dtf = jax_operands(params, ja, nfreq)
    t_fk, t_ctr, t_dtf = tagg.kernel_operands(
        *torch_all(*[params[k] for k in ("features", "queries", "keys",
                                         "frequencies",
                                         "distance_transform")]), ta)
    np.testing.assert_array_equal(t_dtf.numpy(), np.asarray(j_dtf))

    blocks = dict(block_n=16, block_e=128)
    ref = jkagg.totals(D, None, ja.wl_fwd, ja.ent_geo, j_ctr, **blocks)
    got = tkagg.totals(D, None, ta.ctr_ent, ta.ent_geo, t_ctr)
    assert_out_close(got.numpy()[tpos], np.asarray(ref)[jpos], "totals")

    ref, ref_tot = jkagg.forward(D, L, K, nfreq, None, ja.wl_fwd, ja.ent_geo,
                                 j_fk, j_ctr, j_dtf, ladder=ladder,
                                 with_totals=True, **blocks)
    got, got_tot = tkagg.forward(D, L, K, nfreq, None, ta.ctr_ent,
                                 ta.ent_geo, t_fk, t_ctr, t_dtf,
                                 ladder=ladder, with_totals=True)
    assert_out_close(got.numpy()[tpos], np.asarray(ref)[jpos], "forward")
    assert_out_close(got_tot.numpy()[tpos], np.asarray(ref_tot)[jpos],
                     "forward totals")
    alone = tkagg.forward(D, L, K, nfreq, None, ta.ctr_ent, ta.ent_geo, t_fk,
                          t_ctr, t_dtf, ladder=ladder)
    assert torch.equal(alone, got)
    assert not got.numpy()[ta.cid.numpy() == P].any()

    g = rng.normal(size=(P, L)).astype(np.float32)
    j_g = np.zeros((j_ctr.shape[0], L), np.float32)
    j_g[jpos] = g
    t_g = np.zeros((t_ctr.shape[0], L), np.float32)
    t_g[tpos] = g
    j_dent, j_slab = jkagg.backward(
        D, L, K, nfreq, None, ja.wl_bwd, ja.ent_geo, j_fk, j_ctr, j_dtf,
        jnp.asarray(j_g), jnp.asarray(j_g.sum(1, keepdims=True)),
        ladder=ladder, **blocks)
    t_dent, t_dctr = tkagg.backward(
        D, L, K, nfreq, None, (ta.ctr_ent, ta.ent_ctr), ta.ent_geo, t_fk,
        t_ctr, t_dtf, torch.from_numpy(t_g),
        torch.from_numpy(t_g.sum(1, keepdims=True)), ladder=ladder)
    S = K + 2 * E + nfreq
    assert t_dent.shape == (L + K, ta.ent_gid.shape[0])
    assert t_dctr.shape == (t_ctr.shape[0], S)

    def grad_close(got, ref, what):
        np.testing.assert_allclose(
            got, ref, rtol=2e-3,
            atol=1e-4 * max(1.0, float(np.abs(ref).max())), err_msg=what)

    grad_close(by_gaussian(t_dent.numpy(), ta.ent_gid.numpy(), P),
               by_gaussian(np.asarray(j_dent), np.asarray(ja.ent_gid), P),
               "per-entry rows")
    # dgs_tpu's per-item slab -> per-centre rows (aggregate_pallas's
    # backward).
    W = ja.wl_bwd[0].shape[0]
    j_rows = np.asarray(jax.ops.segment_sum(
        j_slab.reshape(W, 16 * S), ja.wl_bwd[1],
        num_segments=j_ctr.shape[0] // 16)).reshape(-1, S)
    grad_close(t_dctr.numpy()[tpos, :K], j_rows[jpos, :K], "dqueries")
    grad_close(t_dctr.numpy()[:, K:].sum(0), j_rows[:, K:].sum(0),
               "code columns")


@pytest.mark.parametrize("D", [1, 2, 3])
def test_aggregate_pallas_matches(rng, D):
    """aggregate_pallas: outputs (rtol 2e-4) and all six gradients (rtol
    2e-3) against dgs_tpu's aggregate_pallas and against the port's own
    aggregate over an untruncated table; gradients bitwise equal in two
    runs."""
    P, L, K, nfreq = 150, 5, 3, 2
    means, conics, radii, params = make_inputs(rng, P, D, L, K, nfreq)
    ja, ta = structures(means, conics, radii, D)
    ref, g_ref = outputs_and_grads(
        "jax", lambda *a: jagg.aggregate_pallas(
            *a, ja, period=None, block_n=16, block_e=128), params)
    got, g_got = outputs_and_grads(
        "torch", lambda *a: tagg.aggregate_pallas(*a, ta), params)
    assert_out_close(got, ref, f"D={D}")
    assert_grads_close(g_got, g_ref, f"D={D}")
    _, again = outputs_and_grads(
        "torch", lambda *a: tagg.aggregate_pallas(*a, ta), params)
    for k in GROUPS:
        np.testing.assert_array_equal(again[k], g_got[k])
    tn = tagg.preprocess(TConfig().with_dims(D),
                         *torch_all(means, conics, radii), P)
    assert int(tn.overflow) == 0
    tab, g_tab = outputs_and_grads(
        "torch", lambda *a: tagg.aggregate(*a, tn), params)
    assert_out_close(got, tab, f"table D={D}")
    assert_grads_close(g_got, g_tab, f"table D={D}")
    # The real period on pre-shifted entries is a no-op.
    wrapped, _ = outputs_and_grads(
        "torch", lambda *a: tagg.aggregate_pallas(*a, ta, period=2.0),
        params)
    assert_out_close(wrapped, got, "period=2.0")


def test_aggregate_pallas_culled_and_open_domain(rng):
    D, P, L, K, nfreq = 2, 120, 4, 2, 2
    means, conics, radii, params = make_inputs(rng, P, D, L, K, nfreq, cull=7)
    ja, ta = structures(means, conics, radii, D, OPEN)
    ref, g_ref = outputs_and_grads(
        "jax", lambda *a: jagg.aggregate_pallas(
            *a, ja, period=None, block_n=16, block_e=128), params)
    got, g_got = outputs_and_grads(
        "torch", lambda *a: tagg.aggregate_pallas(*a, ta), params)
    assert_out_close(got, ref)
    assert_grads_close(g_got, g_ref)
    assert not got[::7].any() and not g_got["queries"][::7].any()


def test_aggregate_pallas_grads_with_entry_major_rows(rng, monkeypatch):
    """The six-gradient twin at D = 2 with the backward's per-entry rows
    handed to segment_sum_rows as the CUDA kernels hand them, the transpose
    view of an entry-major (Ep, L + K) buffer: the same outputs and
    gradients as dgs_tpu's aggregate_pallas, and the segment-sum reads the
    view in place."""
    from dgs_tpu_torch.kernels import segment

    D, P, L, K, nfreq = 2, 150, 5, 3, 2
    backward, plain = tkagg.backward, segment.segment_sum_plain
    strides = []

    def entry_major(*args, **kw):
        dent, dctr = backward(*args, **kw)
        return dent.T.contiguous().T, dctr

    def spy(rows, order, starts):
        strides.append(rows.stride())
        return plain(rows, order, starts)

    monkeypatch.setattr(tkagg, "backward", entry_major)
    monkeypatch.setattr(segment, "segment_sum_plain", spy)
    means, conics, radii, params = make_inputs(rng, P, D, L, K, nfreq)
    ja, ta = structures(means, conics, radii, D)
    ref, g_ref = outputs_and_grads(
        "jax", lambda *a: jagg.aggregate_pallas(
            *a, ja, period=None, block_n=16, block_e=128), params)
    got, g_got = outputs_and_grads(
        "torch", lambda *a: tagg.aggregate_pallas(*a, ta), params)
    assert_out_close(got, ref)
    assert_grads_close(g_got, g_ref)
    assert strides and all(st == (1, L + K) for st in strides)


@pytest.mark.parametrize("D", [1, 2, 3])
def test_ladder_frequencies_recurrence(rng, D):
    """ladder_frequencies against dgs_tpu's, and against the port's direct
    code at the JAX test's tolerances (outputs rtol 1e-5, gradients rtol
    1e-4, test_aggregation_pallas.py:162-170), with the chain onto a shared
    base."""
    P, L, K, nfreq = 120, 5, 3, 4
    means, conics, radii, params = make_inputs(rng, P, D, L, K, nfreq)
    rungs = np.arange(1, nfreq + 1, dtype=np.float32)
    params["frequencies"] = np.float32(0.83) * rungs
    ja, ta = structures(means, conics, radii, D)

    def tfn(ladder):
        return lambda *a: tagg.aggregate_pallas(
            *a, ta, ladder_frequencies=ladder)

    ref, g_ref = outputs_and_grads(
        "jax", lambda *a: jagg.aggregate_pallas(
            *a, ja, period=None, block_n=16, block_e=128,
            ladder_frequencies=True), params)
    got, g_got = outputs_and_grads("torch", tfn(True), params)
    assert_out_close(got, ref, f"D={D}")
    assert_grads_close(g_got, g_ref, f"D={D}")
    direct, g_direct = outputs_and_grads("torch", tfn(False), params)
    np.testing.assert_allclose(
        got, direct, rtol=1e-5,
        atol=1e-5 * max(1.0, float(np.abs(direct).max())))
    for k in GROUPS:
        np.testing.assert_allclose(
            g_got[k], g_direct[k], rtol=1e-4,
            atol=1e-5 * max(1.0, float(np.abs(g_direct[k]).max())),
            err_msg=f"dL/d{k} (D={D})")

    # The shared base: its gradient is the ladder-weighted sum of the
    # per-rung partials, chained by autograd.
    base = torch.tensor(0.83, requires_grad=True)
    fixed = torch_all(*[params[k] for k in GROUPS])
    out = tfn(True)(*fixed[:4], base * torch.from_numpy(rungs), fixed[5])
    (db,) = torch.autograd.grad((out * torch.cos(out)).sum(), base)
    np.testing.assert_allclose(float(db),
                               float((g_ref["frequencies"] * rungs).sum()),
                               rtol=1e-4, atol=1e-6)


def test_fused_totals_matches_separate_totals_sweep(rng):
    """fused_totals over a compute_totals=False structure against the
    separate totals sweep (the JAX test's tolerances: outputs rtol 1e-4,
    gradients rtol 2e-4), and against dgs_tpu's fused mode."""
    D, L, K, nfreq = 2, 4, 3, 2
    means, conics, radii, params = make_inputs(rng, 50, D, L, K, nfreq)
    ja, ta = structures(means, conics, radii, D, compute_totals=False)
    _, ts = structures(means, conics, radii, D)
    ref, g_ref = outputs_and_grads(
        "jax", lambda *a: jagg.aggregate_pallas(
            *a, ja, block_n=16, block_e=128, fused_totals=True), params)
    got, g_got = outputs_and_grads(
        "torch", lambda *a: tagg.aggregate_pallas(*a, ta, fused_totals=True),
        params)
    sep, g_sep = outputs_and_grads(
        "torch", lambda *a: tagg.aggregate_pallas(*a, ts), params)
    assert_out_close(got, ref)
    assert_grads_close(g_got, g_ref)
    np.testing.assert_allclose(
        got, sep, rtol=1e-4, atol=1e-5 * max(1.0, float(np.abs(sep).max())))
    for k in GROUPS:
        np.testing.assert_allclose(
            g_got[k], g_sep[k], rtol=2e-4,
            atol=2e-5 * max(1.0, float(np.abs(g_sep[k]).max())),
            err_msg=f"dL/d{k}")


def test_tile_range_with_padded_outputs(rng):
    """The shard form: a structure over a tile range, raw per-slot rows.
    Centres inside match dgs_tpu's and the full structure's rows; centres
    outside are absent (pos == Cp) and get zero rows and zero gradients;
    the two halves add up to the whole."""
    D, P, L, K, nfreq = 2, 120, 4, 3, 2
    means, conics, radii, params = make_inputs(rng, P, D, L, K, nfreq)
    jc, _ = jagg.plan_pallas(JConfig(), *jnp_all(means, radii), block_n=16)
    T = int(np.prod(jc.grid_shape()))
    cut = T // 2
    args = torch_all(*[params[k] for k in GROUPS])
    _, full = structures(means, conics, radii, D)
    whole = tagg.aggregate_pallas(*args, full).numpy()
    total = np.zeros_like(whole)
    for tile_range in ((0, cut), (cut, T)):
        ja, ta = structures(means, conics, radii, D, tile_range=tile_range)
        Cp = ta.cid.shape[0]
        inside = ta.pos.numpy() < Cp
        assert 0 < inside.sum() < P
        np.testing.assert_array_equal(inside, np.asarray(ja.pos)
                                      < ja.cid.shape[0])
        ref = np.asarray(jagg.aggregate_pallas(
            *jnp_all(*[params[k] for k in GROUPS]), ja, block_n=16,
            block_e=128, padded_outputs=True))
        pad = tagg.aggregate_pallas(*args, ta, padded_outputs=True).numpy()
        assert pad.shape == (Cp, L)
        assert_out_close(pad[ta.pos.numpy()[inside]],
                         ref[np.asarray(ja.pos)[inside]], str(tile_range))
        assert not pad[ta.cid.numpy() == P].any()
        out, grads = outputs_and_grads(
            "torch", lambda *a: tagg.aggregate_pallas(*a, ta), params)
        assert not out[~inside].any()
        assert not grads["queries"][~inside].any()
        assert_out_close(out[inside], whole[inside], str(tile_range))
        total += out
    assert_out_close(total, whole, "halves")


@pytest.mark.parametrize("D, E", [(1, 6), (2, 11)])
def test_code_stride_with_unused_columns(rng, D, E):
    """A distance transform whose stride (E - 1) // D is 2 nfreq + 1 leaves
    one column of each dimension's block unused (E - 2 at D = 1; 4 and 9
    at D = 2, E = 11): outputs and all six gradients against dgs_tpu's,
    and exactly zero d(distance_transform) in the unused columns."""
    P, L, K, nfreq = 120, 4, 3, 2
    assert (E - 1) // D == 2 * nfreq + 1
    means, conics, radii, params = make_inputs(rng, P, D, L, K, nfreq,
                                               cull=7)
    params["distance_transform"] = rng.normal(0.0, 0.5, (2 * E,)).astype(
        np.float32)
    ja, ta = structures(means, conics, radii, D)
    ref, g_ref = outputs_and_grads(
        "jax", lambda *a: jagg.aggregate_pallas(
            *a, ja, period=None, block_n=16, block_e=128), params)
    got, g_got = outputs_and_grads(
        "torch", lambda *a: tagg.aggregate_pallas(*a, ta), params)
    assert_out_close(got, ref, f"D={D}, E={E}")
    assert_grads_close(g_got, g_ref, f"D={D}, E={E}")
    unused = [d * (E - 1) // D + 2 * nfreq for d in range(D)]
    ddt = g_got["distance_transform"]
    assert not ddt[unused].any() and not ddt[[E + u for u in unused]].any()
    assert ddt[:E - 1].any()


def test_plain_chunks_of_pad_rows_only(rng, monkeypatch):
    """With few rows a chunk, whole chunks of the plain versions hold only
    pad centres (empty ranges) and are skipped; their rows of the
    backward's dctr are still exactly zero, and the gradients match
    dgs_tpu's.  The allocator's free block is filled with NaN first, so a
    row left unwritten shows."""
    D, P, L, K, nfreq = 2, 90, 4, 3, 2
    means, conics, radii, params = make_inputs(rng, P, D, L, K, nfreq, cull=7)
    ja, ta = structures(means, conics, radii, D)
    monkeypatch.setattr(tkagg, "PLAIN_ROWS", 8)
    Cp = ta.cid.shape[0]
    live = (ta.ctr_ent[1] > ta.ctr_ent[0]).numpy()
    assert not live[-8:].any()       # a last chunk of pad centres alone
    ref, g_ref = outputs_and_grads(
        "jax", lambda *a: jagg.aggregate_pallas(
            *a, ja, period=None, block_n=16, block_e=128), params)
    got, g_got = outputs_and_grads(
        "torch", lambda *a: tagg.aggregate_pallas(*a, ta), params)
    assert_out_close(got, ref)
    assert_grads_close(g_got, g_ref)

    t_fk, t_ctr, t_dtf = tagg.kernel_operands(
        *torch_all(*[params[k] for k in ("features", "queries", "keys",
                                         "frequencies",
                                         "distance_transform")]), ta)
    S = K + 2 * (2 * D * nfreq + 1) + nfreq
    torch.full((Cp, S), float("nan"))
    gpre = torch.from_numpy(rng.normal(size=(Cp, L)).astype(np.float32))
    _, dctr = tkagg.backward_plain(
        D, L, K, nfreq, None, (ta.ctr_ent, ta.ent_ctr), ta.ent_geo, t_fk,
        t_ctr, t_dtf, gpre, gpre.sum(1, keepdim=True))
    assert not dctr[torch.from_numpy(~live)].any()
