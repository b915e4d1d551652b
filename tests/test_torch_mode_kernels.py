"""The kernel modes' CUDA sources (csrc/tiled_forward_sep.cu,
csrc/tiled_backward_moments.cu) built for the host with g++ against the
emulated CUDA runtime of cuda_emulation.py (tf32_mma.cuh's mma.sync computed
from the lanes' gathered fragments, its TF32 rounding the same as the
card's), run on operands of the port's binning and held against their plain
versions: the separable forward at 3 passes within the fp32 gate and at 1
pass within its sanity bound (a coarse-tile case where the 1-pass
contraction puts kept pairs above PSD_TOL, so that the kernel recomputes
their power per pair), the moment-form backward within the gradient
tolerance and, folded by moment_combine, against the classic backward on
the same tile-local operands; blocks of ranges that straddle two tiles;
pad and sentinel columns exactly zero; two runs bitwise equal; the
backward's operands off a 16-byte boundary refused; h_matmul's
instantiations too.  This checks the kernels' logic
(fragment layouts, ranges, channel passes, the row layout), not the card's
speed: chip_smoke.py holds the same functions on the H100."""

import ctypes

import numpy as np
import pytest
import torch

import cuda_emulation
from conftest import make_gaussians, make_samples
from dgs_tpu_torch.binning import grid as tgrid
from dgs_tpu_torch.config import SamplerConfig as TConfig
from dgs_tpu_torch.kernels import tiled as kt
from dgs_tpu_torch.ops import formulas

torch.set_num_threads(2)

ORDERS = ("value", "derivative", "laplacian", "third")
P_, I_ = ctypes.c_void_p, ctypes.c_int


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    fwd, bwd = cuda_emulation.build(tmp_path_factory.mktemp("modes"),
                                    ["tiled_forward_sep",
                                     "tiled_backward_moments"])
    fwd.dgs_tiled_forward_sep.argtypes = [P_, I_, I_, P_, I_, P_, P_] + \
        [I_] * 8 + [P_, P_]
    fwd.dgs_tiled_forward_sep_block.argtypes = []
    bwd.dgs_tiled_backward_moments.argtypes = [P_, I_, I_, P_, I_, P_, P_,
                                               P_] + [I_] * 7 + [P_, P_]
    bwd.dgs_tiled_backward_moments_hmm.argtypes = [
        P_, I_, I_, P_, I_, P_, P_, P_] + [I_] * 8 + [P_, P_]
    bwd.dgs_tiled_backward_moments_rows.argtypes = [I_, I_]
    bwd.dgs_tiled_backward_moments_block.argtypes = [I_]
    return fwd, bwd


def _operands(D, C, seed, tile=0.1275, P=None, holes=False,
              at_means=False):
    """Tile-local operands of a seeded case: (geom, mono, state, cfg).
    ``at_means``: the first P / 2 samples lie within 1e-3 of a mean."""
    rng = np.random.default_rng(seed)
    P = P or (60 if D < 3 else 50)
    m, v, cov, c = map(torch.from_numpy, make_gaussians(
        rng, P, D, C, sigma_range=(0.02, 0.05)))
    s = torch.from_numpy(make_samples(rng, 96, D))
    if at_means:
        s[:P // 2] = m[:P // 2] + torch.from_numpy(
            1e-3 * rng.standard_normal((P // 2, D)).astype(np.float32))
    if holes:       # tiles with entries only, with samples only, with neither
        s[:, 0] = -s[:, 0].abs()
        m[:, -1] = -m[:, -1].abs()
    cfg = TConfig(max_tiles_per_gaussian=8, tile_size=tile, eig_floor=1e-12,
                  entry_capacity_factor=100.0).with_dims(D)
    state = tgrid.build(cfg, m, cov, s)
    assert int(state.overflow) == 0 and int(state.entry_overflow) == 0
    geom = kt.prepare_entries(state, m, v, c, kt.BLOCK_E, cfg=cfg,
                              separable=True)[2]
    mono = kt.prepare_samples(state, s, kt.BLOCK_N, cfg=cfg,
                              separable=True)[0]
    return geom, mono, state


def _forward(fwd, orders, D, C, geom, mono, lo, n, passes):
    mask, rows = kt._order_rows(orders, D)
    K = kt.total_unique(orders, D)
    Np = mono.shape[1]
    out = torch.full((K * C, Np), float("nan"))
    err = fwd.dgs_tiled_forward_sep(
        geom.data_ptr(), geom.shape[1], C, mono.data_ptr(), Np,
        lo.data_ptr(), n.data_ptr(), Np // kt.BLOCK_N, D, mask, passes,
        rows["value"], rows["derivative"], rows["laplacian"], rows["third"],
        out.data_ptr(), None)
    assert err == 0
    return out


def _tf32(x):
    """x (float32) rounded to TF32 as tf32_mma.cuh rounds: to nearest, ties
    away from zero, on the 13 dropped mantissa bits."""
    u = x.contiguous().view(torch.int32)
    r = torch.where((u & 0x7f800000) != 0x7f800000,
                    (u + 0x1000) & -0x2000, u)
    return r.view(torch.float32)


def _recomputed_pairs(D, C, geom, mono, state):
    """The kept pairs (same tile) whose 1-pass contracted power (a float64
    model of the kernel's: the constant column u exact, every other
    operand rounded to TF32) exceeds PSD_TOL while their per-pair power
    (-1/2 X^T C X) does not: the pairs the kernel recomputes."""
    tri = kt.tri_size(D)
    MR, MP = kt.mono_rows(D), 1 + D
    np0 = 1 + D + tri + C
    prow = torch.cat([geom[np0:np0 + MP], geom[1 + D:1 + D + tri]], 0)
    coef = torch.cat([prow[:1], _tf32(prow[1:])], 0).double()
    mono_r = torch.cat([mono[:1], _tf32(mono[1:MR])], 0).double()
    contracted = mono_r.T @ coef                              # (Np, Ep)
    Xs = [geom[1 + d][None, :] - mono[1 + d][:, None] for d in range(D)]
    con = [geom[1 + D + u][None, :] for u in range(tri)]
    pair = -0.5 * sum(r * X for r, X in zip(
        formulas.conic_apply(Xs, con, D), Xs))
    same = (geom[0][None, :] == mono[MR][:, None]) & (geom[0][None, :] >= 0)
    return int((same & (contracted > kt.PSD_TOL)
                & (pair <= kt.PSD_TOL)).sum())


def _backward(bwd, orders, D, C, geom, mono, ct, lo, n, hmm=False,
              refused=False):
    mask, rows = kt._order_rows(orders, D)
    n_rows = kt.moment_layout(orders, D)[3]
    assert bwd.dgs_tiled_backward_moments_rows(D, mask) == n_rows
    Ep = geom.shape[1]
    out = torch.full((Ep, n_rows + C), float("nan"))
    args = (geom.data_ptr(), Ep, C, mono.data_ptr(), mono.shape[1],
            ct.data_ptr(), lo.data_ptr(), n.data_ptr(), Ep // kt.BLOCK_E, D,
            mask, rows["value"], rows["derivative"], rows["laplacian"],
            rows["third"])
    if hmm:
        err = bwd.dgs_tiled_backward_moments_hmm(*args, 3, out.data_ptr(),
                                                 None)
    else:
        err = bwd.dgs_tiled_backward_moments(*args, out.data_ptr(), None)
    assert (err != 0) == refused
    return out.T


def _check_close(got, ref, rtol, atol_rel, what):
    scale = max(1.0, float(ref.abs().max()))
    bad = (got - ref).abs() > atol_rel * scale + rtol * ref.abs()
    assert not bool(bad.any()), (what, int(bad.sum()),
                                 float((got - ref).abs().max()))


CASES = [(1, 4, ORDERS, False), (2, 4, ORDERS, False),
         (3, 4, ORDERS, False), (2, 1, ORDERS, False),
         (2, 2, ("laplacian", "value"), False), (3, 6, ("third",), False),
         (3, 1, ("value",), False), (2, 4, ("derivative",), False),
         # h_matmul: C = 6 in two channel passes, C = 1 at one
         (3, 6, ("value", "derivative", "laplacian"), True),
         (2, 1, ORDERS, True)]
# A coarse tile (0.2, the D = 3 bench's) with samples at means: the 1-pass
# contraction's roundoff puts kept pairs whose power is ~0 above PSD_TOL.
COARSE = 0.2
CASES += [(3, 4, ("value", "derivative", "laplacian"), False, COARSE)]


@pytest.mark.parametrize(
    "D,C,orders,hmm,tile", [c + (0.1275,) * (5 - len(c)) for c in CASES],
    ids=[f"D{c[0]}_C{c[1]}_{len(c[2])}" + ("_hmm" if c[3] else "")
         + ("_coarse" if len(c) > 4 else "") for c in CASES])
def test_emulated_mode_kernels_match_plain(libs, D, C, orders, hmm, tile):
    """The separable forward and the moment-form backward (with or without
    h_matmul) against their plain versions; every case has 32-entry ranges
    and blocks of ranges that straddle two tiles, the forward's blocks of
    ranges too; both kernels' second runs are bitwise equal (the forward at
    3 and at 1 pass), and a misaligned monomial or cotangent operand of the
    backward is refused.  The coarse case has pairs that the 1-pass forward
    recomputes per pair."""
    fwd, bwd = libs
    geom, mono, state = _operands(D, C, 100 * D + C, tile=tile,
                                  at_means=tile == COARSE)
    Np, Ep = mono.shape[1], geom.shape[1]
    for block in (kt.BLOCK_E, bwd.dgs_tiled_backward_moments_block(D)):
        assert cuda_emulation.straddles(geom[0], block)
    # a block of the separable forward: a lane a sample
    for block in (kt.BLOCK_N, fwd.dgs_tiled_forward_sep_block()):
        assert cuda_emulation.straddles(mono[-1], block)
    if tile == COARSE:
        assert _recomputed_pairs(D, C, geom, mono, state) > 0
    lo, n = kt.entry_ranges(state, Np)
    ref = kt.tiled_forward_sep_plain(orders, D, C, geom, mono, lo, n)
    got = _forward(fwd, orders, D, C, geom, mono, lo, n, passes=3)
    k0 = 0
    for order in orders:      # the fp32 gate, per order
        r = slice(k0 * C, (k0 + formulas.n_unique(order, D)) * C)
        _check_close(got[r], ref[r], 2e-4, 1e-5, order)
        k0 += formulas.n_unique(order, D)
    assert not bool(got[:, mono[-1] < 0].any())      # pad columns
    one = _forward(fwd, orders, D, C, geom, mono, lo, n, passes=1)
    assert float((one - got).abs().max()) <= 2e-2 * float(got.abs().max())
    assert not bool(one[:, mono[-1] < 0].any())
    assert torch.equal(_forward(fwd, orders, D, C, geom, mono, lo, n, 3),
                       got)
    assert torch.equal(_forward(fwd, orders, D, C, geom, mono, lo, n, 1),
                       one)

    K = kt.total_unique(orders, D)
    ct = torch.from_numpy(np.random.default_rng(D).standard_normal(
        (K * C, Np)).astype(np.float32))
    s_lo, s_n = kt.sample_ranges(state, Ep)
    rows = _backward(bwd, orders, D, C, geom, mono, ct, s_lo, s_n, hmm)
    ref_rows = kt.tiled_backward_moments_plain(orders, D, C, geom, mono, ct,
                                               s_lo, s_n)
    _check_close(rows, ref_rows, 2e-3, 1e-5, "moment rows")
    dead = (geom[0] < 0) | (geom[0] >= state.ent_start.shape[0] - 2)
    assert not bool(rows[:, dead].any())
    assert torch.equal(_backward(bwd, orders, D, C, geom, mono, ct, s_lo,
                                 s_n, hmm), rows)
    # operands off a 16-byte boundary are refused (the copies are 16 bytes)
    for m, c in ((cuda_emulation.misaligned(mono), ct),
                 (mono, cuda_emulation.misaligned(ct))):
        _backward(bwd, orders, D, C, geom, m, c, s_lo, s_n, hmm,
                  refused=True)
    combined = kt.moment_combine(orders, D, C, rows, geom)
    classic = kt.tiled_backward_plain(
        orders, None, D, C, kt.base_rows(geom, D, C),
        kt.local_samples(mono, D), ct, s_lo, s_n)
    _check_close(combined, classic, 2e-3, 1e-5, "combined rows")


def test_emulated_mode_kernels_with_empty_tiles(libs):
    """Tiles with entries and no samples, samples and no entries, neither
    (D = 2), and full-cover footprints' long ranges at a coarse tile."""
    fwd, bwd = libs
    for geom, mono, state in (_operands(2, 4, 7, holes=True),
                              _operands(2, 4, 8, tile=0.5, P=20)):
        D, C, Np, Ep = 2, 4, mono.shape[1], geom.shape[1]
        lo, n = kt.entry_ranges(state, Np)
        got = _forward(fwd, ORDERS, D, C, geom, mono, lo, n, 3)
        ref = kt.tiled_forward_sep_plain(ORDERS, D, C, geom, mono, lo, n)
        _check_close(got, ref, 2e-4, 1e-5, "forward")
        ct = torch.ones((kt.total_unique(ORDERS, D) * C, Np))
        s_lo, s_n = kt.sample_ranges(state, Ep)
        rows = _backward(bwd, ORDERS, D, C, geom, mono, ct, s_lo, s_n)
        ref_rows = kt.tiled_backward_moments_plain(ORDERS, D, C, geom, mono,
                                                   ct, s_lo, s_n)
        _check_close(rows, ref_rows, 2e-3, 1e-5, "moment rows")
