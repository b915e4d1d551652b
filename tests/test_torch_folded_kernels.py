"""The folded modes' CUDA sources (csrc/tiled_forward_folded.cu,
csrc/tiled_backward_folded.cu, csrc/tiled_backward_fvjp.cu) and the
h_matmul backwards (csrc/tiled_backward_hmm.cu, and the h_matmul
instantiations of csrc/tiled_backward_moments.cu and of the folded
dvalues) built for the host
with g++ against the emulated CUDA runtime of cuda_emulation.py
(tf32_mma.cuh's mma.sync computed from the lanes' fragments, its TF32
rounding the card's; cp_async.cuh's copies done at once), run on operands
of the port's binning and held against their plain versions at 3 TF32
passes: the forward within the fp32 kernel gate, the backwards within the
gradient tolerance; pad and sentinel columns exactly zero; two runs
bitwise equal; operands off a 16-byte boundary refused.  The cases cover R from 13 to 150 in one pass of the
folded forward (384 rows), of the folded dvalues (128 or 320 rows) and one
Zd window of the folded VJP, and R = 390 and 546 in two passes of the
forward and the folded dvalues (546 also in two Zd windows of the VJP, its
samples swept again); blocks whose samples or
entries straddle two tiles; value-only orders; C = 1, 2, 4 and 6 (two
channel passes of the classic VJP).  This checks the kernels' logic
(fragment layouts, staging, passes, ranges, the row tables), not the
card's speed or its tensor cores' summation: chip_smoke.py holds the same
functions on the H100."""

import ctypes

import numpy as np
import pytest
import torch

import cuda_emulation
from conftest import make_gaussians, make_samples
from dgs_tpu_torch.binning import grid as tgrid
from dgs_tpu_torch.config import SamplerConfig as TConfig, tri_size
from dgs_tpu_torch.kernels import tiled as kt

torch.set_num_threads(2)

ORDERS = ("value", "derivative", "laplacian", "third")
THREE = ("value", "derivative", "laplacian")
P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    fwd, bwd, fvjp, hmm, mom = cuda_emulation.build(
        tmp_path_factory.mktemp("folded"),
        ["tiled_forward_folded", "tiled_backward_folded",
         "tiled_backward_fvjp", "tiled_backward_hmm",
         "tiled_backward_moments"])
    fwd.dgs_tiled_forward_folded.argtypes = [
        P_, I_, P_, I_, I_, P_, I_, I_, P_, P_, I_, I_, I_, P_, I_, P_, P_]
    bwd.dgs_tiled_backward_fdv.argtypes = [
        P_, I_, I_, P_, I_, P_, P_, I_, I_, P_, P_] + [I_] * 9 + [P_, P_]
    bwd.dgs_tiled_backward_fdv_pass_rows.argtypes = [I_] * 5
    fvjp.dgs_tiled_backward_fvjp.argtypes = [
        P_, I_, I_, P_, P_, P_, I_, I_, P_, I_, P_, P_, I_, I_, P_, I_, I_,
        P_, P_]
    hmm.dgs_tiled_backward_hmm.argtypes = [
        P_, I_, I_, P_, I_, P_, P_, P_, I_, I_, I_, I_, F_] + [I_] * 5 + [
        P_, P_]
    hmm.dgs_tiled_backward_hmm_rows.argtypes = []
    mom.dgs_tiled_backward_moments_hmm.argtypes = [
        P_, I_, I_, P_, I_, P_, P_, P_] + [I_] * 8 + [P_, P_]
    return fwd, bwd, fvjp, hmm, mom


def _close(got, ref, rtol, what):
    scale = max(1.0, float(ref.abs().max()))
    bad = (got - ref).abs() > 1e-5 * scale + rtol * ref.abs()
    assert not bool(bad.any()), (what, int(bad.sum()),
                                 float((got - ref).abs().max()))


def _case(D, C, orders, seed, P=24, N=64):
    """Folded operands of a seeded wrap-free case."""
    rng = np.random.default_rng(seed)
    m, v, cov, c = map(torch.from_numpy, make_gaussians(
        rng, P, D, C, sigma_range=(0.02, 0.05)))
    s = torch.from_numpy(make_samples(rng, N, D))
    cfg = TConfig(max_tiles_per_gaussian=8, tile_size=0.1275,
                  eig_floor=1e-12, entry_capacity_factor=100.0,
                  unwrapped_kernels=True).with_dims(D)
    state = tgrid.build(cfg, m, cov, s)
    assert int(state.overflow) == 0 and int(state.entry_overflow) == 0
    meta, n_mono, R, Rp = kt.folded_layout(orders, D, C)
    _, _, geom, _, fold, foldw = kt.prepare_entries(
        state, m, v, c, kt.BLOCK_E, cfg=cfg, folded=orders, fold_meta=meta,
        folded_vjp=True)
    mono = kt.prepare_samples(state, s, kt.BLOCK_N, cfg=cfg,
                              folded_deg=kt.folded_degree(orders))[0]
    assert mono.shape[0] == n_mono + 1
    ct = torch.from_numpy(rng.standard_normal(
        (kt.total_unique(orders, D) * C, mono.shape[1])).astype(np.float32))
    return dict(state=state, cfg=cfg, m=m, v=v, c=c, s=s, geom=geom,
                fold=fold, foldw=foldw, mono=mono, ct=ct, meta=meta,
                n_mono=n_mono, R=R, Rp=Rp,
                cb=kt.ct_beta_rows(meta, C, ct, mono),
                local=kt.local_samples(mono, D))


def _forward(fwd, orders, D, C, k, lo, n):
    K = kt.total_unique(orders, D)
    Np = k["mono"].shape[1]
    rowmap = torch.tensor([(i * C + c) * 32 + m
                           for i, mrows in enumerate(k["meta"])
                           for m in mrows for c in range(C)],
                          dtype=torch.int32)
    out = torch.full((K * C, Np), float("nan"))
    assert fwd.dgs_tiled_forward_folded(
        k["geom"].data_ptr(), k["geom"].shape[1], k["fold"].data_ptr(),
        k["Rp"], k["R"], k["mono"].data_ptr(), Np, k["n_mono"],
        lo.data_ptr(), n.data_ptr(), Np // kt.BLOCK_N, D, K * C,
        rowmap.data_ptr(), 3, out.data_ptr(), None) == 0
    return out


def _fdv(bwd, orders, D, C, k, s_lo, s_n, hmm, cb=None, refused=False):
    mask, rows = kt._order_rows(orders, D)
    Ep, Np = k["geom"].shape[1], k["mono"].shape[1]
    cb = k["cb"] if cb is None else cb
    out = torch.full((Ep, D + tri_size(D) + C), float("nan"))
    err = bwd.dgs_tiled_backward_fdv(
        k["geom"].data_ptr(), Ep, C, k["local"].data_ptr(), Np,
        k["ct"].data_ptr(), cb.data_ptr(), k["Rp"], k["R"],
        s_lo.data_ptr(), s_n.data_ptr(), Ep // kt.BLOCK_E, D, mask,
        rows["value"], rows["derivative"], rows["laplacian"], rows["third"],
        3, int(hmm), out.data_ptr(), None)
    assert (err != 0) == refused
    return out.T


def _fvjp(fvjp, orders, D, C, k, s_lo, s_n):
    groups = kt.fvjp_vz_groups(orders, D)
    slot = [-1] * (k["R"] // C)
    for j, i in enumerate(groups):
        slot[i] = j
    sel = torch.tensor(slot, dtype=torch.int32)
    Ep, Np = k["geom"].shape[1], k["mono"].shape[1]
    out = torch.full((Ep, D + tri_size(D) + C + len(groups)), float("nan"))
    assert fvjp.dgs_tiled_backward_fvjp(
        k["geom"].data_ptr(), Ep, C, k["fold"].data_ptr(),
        k["foldw"].data_ptr(), k["cb"].data_ptr(), k["Rp"], k["R"],
        k["local"].data_ptr(), Np, s_lo.data_ptr(), s_n.data_ptr(),
        Ep // kt.BLOCK_E, D, sel.data_ptr(), len(groups), 3, out.data_ptr(),
        None) == 0
    return out.T


CASES = [(1, 4, ORDERS), (2, 4, THREE), (2, 2, ("value", "laplacian")),
         (3, 1, ("value", "derivative")), (2, 6, ("value",)),
         (1, 4, THREE), (2, 6, ORDERS), (3, 2, ORDERS)]
# (passes of the folded forward, Zd windows of the folded VJP, passes of
# the folded dvalues) where not 1.
TALL = {(2, 6, ORDERS): (2, 1, 2), (3, 2, ORDERS): (2, 2, 2)}


@pytest.mark.parametrize("D,C,orders", CASES,
                         ids=[f"D{d}_C{c}_{len(o)}" for d, c, o in CASES])
def test_emulated_folded_kernels_match_plain(libs, D, C, orders):
    """The folded forward, the folded dvalues (with and without h_matmul)
    and the folded VJP against their plain versions; the folded VJP's rows
    combined against the classic backward on the same operands.  R = 24
    (D = 1, three orders, C = 4) to 546 (D = 3, four orders, C = 2: two
    passes of the forward, two Zd windows of the VJP); the forward's
    64-sample blocks and the VJP's 32-entry blocks straddle tiles."""
    fwd, bwd, fvjp, _, _ = libs
    # the two-window case with fewer Gaussians: the emulation is slow
    k = _case(D, C, orders, 100 * D + C, P=12 if D == 3 and C == 2 else 24)
    Np, Ep = k["mono"].shape[1], k["geom"].shape[1]
    assert cuda_emulation.straddles(k["mono"][-1], 64)
    assert cuda_emulation.straddles(k["geom"][0], kt.BLOCK_E)
    Rp, nsel = k["Rp"], len(kt.fvjp_vz_groups(orders, D))
    mask = kt._order_rows(orders, D)[0]
    assert (-(-Rp // fwd.dgs_tiled_forward_folded_pass_rows(Rp)),
            -(-Rp // fvjp.dgs_tiled_backward_fvjp_window(D, Rp, C, nsel)),
            -(-Rp // bwd.dgs_tiled_backward_fdv_pass_rows(D, mask, Rp, C, 0))
            ) == TALL.get((D, C, orders), (1, 1, 1))
    lo, n = kt.entry_ranges(k["state"], Np)
    got = _forward(fwd, orders, D, C, k, lo, n)
    ref = kt.tiled_forward_folded_plain(orders, D, C, k["geom"], k["fold"],
                                        k["mono"], lo, n)
    _close(got, ref, 2e-4, "folded forward")
    assert not bool(got[:, k["mono"][-1] < 0].any())       # pad columns
    assert torch.equal(_forward(fwd, orders, D, C, k, lo, n), got)

    s_lo, s_n = kt.sample_ranges(k["state"], Ep)
    dead = (k["geom"][0] < 0) | (k["geom"][0] >= tgrid.num_tiles(
        k["cfg"], D))
    ref_fdv = kt.tiled_backward_plain(orders, None, D, C, k["geom"],
                                      k["local"], k["ct"], s_lo, s_n,
                                      cb=k["cb"])
    for hmm in (False, True):
        rows = _fdv(bwd, orders, D, C, k, s_lo, s_n, hmm)
        _close(rows, ref_fdv, 2e-3, f"folded dvalues, h_matmul {hmm}")
        assert not bool(rows[:, dead].any())
        if not hmm:      # again: bitwise equal
            assert torch.equal(_fdv(bwd, orders, D, C, k, s_lo, s_n, hmm),
                               rows)
    # cb off a 16-byte boundary is refused (the copies are 16 bytes)
    _fdv(bwd, orders, D, C, k, s_lo, s_n, False,
         cb=cuda_emulation.misaligned(k["cb"]), refused=True)
    rows = _fvjp(fvjp, orders, D, C, k, s_lo, s_n)
    _close(rows, kt.tiled_backward_fvjp_plain(
        orders, D, C, k["geom"], k["fold"], k["foldw"], k["local"], k["cb"],
        s_lo, s_n), 2e-3, "folded VJP")
    assert not bool(rows[:, dead].any())
    assert torch.equal(_fvjp(fvjp, orders, D, C, k, s_lo, s_n), rows)
    classic = kt.tiled_backward_plain(orders, None, D, C,
                                      kt.base_rows(k["geom"], D, C),
                                      k["local"], k["ct"], s_lo, s_n)
    # Two algorithms: the JAX suite's limit for a mode against the classic
    # path (rtol 2e-3, atol 2e-4 max(1, |ref|)).
    combined = kt.fvjp_combine(orders, D, C, rows, k["geom"])
    scale = max(1.0, float(classic.abs().max()))
    assert not bool(((combined - classic).abs()
                     > 2e-4 * scale + 2e-3 * classic.abs()).any())


def test_emulated_folded_r_split(libs):
    """R = 100 rows (D = 2, three orders, C = 4): one pass of the folded
    forward, seven of its eight warps holding an m16 tile of Z and the
    eighth none, and one Zd window of the folded VJP (four R-chunks of 32
    rows, the last past Rp = 112 zero-filled); both against their plain
    versions."""
    fwd, _, fvjp, _, _ = libs
    k = _case(2, 4, THREE, 7)
    assert k["R"] == 100 and k["Rp"] == 112
    lo, n = kt.entry_ranges(k["state"], k["mono"].shape[1])
    got = _forward(fwd, THREE, 2, 4, k, lo, n)
    ref = kt.tiled_forward_folded_plain(THREE, 2, 4, k["geom"], k["fold"],
                                        k["mono"], lo, n)
    _close(got, ref, 2e-4, "folded forward, one pass")
    s_lo, s_n = kt.sample_ranges(k["state"], k["geom"].shape[1])
    _close(_fvjp(fvjp, THREE, 2, 4, k, s_lo, s_n),
           kt.tiled_backward_fvjp_plain(THREE, 2, 4, k["geom"], k["fold"],
                                        k["foldw"], k["local"], k["cb"],
                                        s_lo, s_n), 2e-3,
           "folded VJP, one window")


HMM_CASES = [(2, 4, ORDERS, True), (3, 6, ORDERS, False),
             (1, 2, THREE, True), (2, 1, ("laplacian", "value"), False),
             (2, 6, THREE, True)]
ONE_PASS_SANITY = 2e-2   # chip_smoke.py's bound on a 1-pass reading


@pytest.mark.parametrize("D,C,orders,wrap", HMM_CASES,
                         ids=[f"D{d}_C{c}_{len(o)}_{'wrapped' if w else 'open'}"
                              for d, c, o, w in HMM_CASES])
def test_emulated_h_matmul_matches_plain(libs, D, C, orders, wrap):
    """h_matmul in the classic backward (wrapped and wrap-free; C = 6 runs
    two channel passes, each contraction over its pass's channels; blocks of
    two 32-entry ranges that straddle two tiles) and in the moment-form
    backward, against their plain versions; two runs bitwise equal, the
    1-pass reading within ONE_PASS_SANITY of the 3-pass one, sentinel
    columns exactly zero, a misaligned sample or cotangent operand
    refused."""
    _, _, _, hmm, mom = libs
    rng = np.random.default_rng(D + C)
    m, v, cov, c = map(torch.from_numpy, make_gaussians(
        rng, 24, D, C, sigma_range=(0.02, 0.05)))
    s = torch.from_numpy(make_samples(rng, 64, D))
    cfg = TConfig(max_tiles_per_gaussian=8, tile_size=0.1275,
                  eig_floor=1e-12, entry_capacity_factor=100.0).with_dims(D)
    state = tgrid.build(cfg, m, cov, s)
    geom = kt.prepare_entries(state, m, v, c, kt.BLOCK_E, cfg=cfg)[2]
    smp, _, Np = kt.prepare_samples(state, s, kt.BLOCK_N, cfg=cfg)
    Ep = geom.shape[1]
    for block in (kt.BLOCK_E, hmm.dgs_tiled_backward_hmm_rows()):
        assert cuda_emulation.straddles(geom[0], block)
    K = kt.total_unique(orders, D)
    ct = torch.from_numpy(rng.standard_normal((K * C, Np)).astype(
        np.float32))
    s_lo, s_n = kt.sample_ranges(state, Ep)
    mask, rows = kt._order_rows(orders, D)
    period = cfg.period if wrap else None

    def classic(passes=3, smp=smp, ct=ct, refused=False):
        out = torch.full((Ep, D + tri_size(D) + C), float("nan"))
        err = hmm.dgs_tiled_backward_hmm(
            geom.data_ptr(), Ep, C, smp.data_ptr(), Np, ct.data_ptr(),
            s_lo.data_ptr(), s_n.data_ptr(), Ep // kt.BLOCK_E, D, mask,
            int(wrap), float(cfg.period), rows["value"], rows["derivative"],
            rows["laplacian"], rows["third"], passes, out.data_ptr(), None)
        assert (err != 0) == refused
        return out.T

    got = classic()
    _close(got, kt.tiled_backward_plain(orders, period, D, C, geom, smp, ct,
                                        s_lo, s_n), 2e-3, "h_matmul classic")
    assert torch.equal(classic(), got)
    dead = (geom[0] < 0) | (geom[0] >= tgrid.num_tiles(cfg, D))
    assert bool(dead.any()) and not bool(got[:, dead].any())
    one = classic(1)
    assert float((one - got).abs().max()) <= ONE_PASS_SANITY * float(
        got.abs().max())
    # operands off a 16-byte boundary are refused (the copies are 16 bytes)
    classic(smp=cuda_emulation.misaligned(smp), refused=True)
    classic(ct=cuda_emulation.misaligned(ct), refused=True)

    gs = kt.prepare_entries(state, m, v, c, kt.BLOCK_E, cfg=cfg,
                            separable=True)[2]
    mono = kt.prepare_samples(state, s, kt.BLOCK_N, cfg=cfg,
                              separable=True)[0]
    n_rows = kt.moment_layout(orders, D)[3]
    out = torch.full((Ep, n_rows + C), float("nan"))
    assert mom.dgs_tiled_backward_moments_hmm(
        gs.data_ptr(), Ep, C, mono.data_ptr(), Np, ct.data_ptr(),
        s_lo.data_ptr(), s_n.data_ptr(), Ep // kt.BLOCK_E, D, mask,
        rows["value"], rows["derivative"], rows["laplacian"], rows["third"],
        3, out.data_ptr(), None) == 0
    _close(out.T, kt.tiled_backward_moments_plain(orders, D, C, gs, mono, ct,
                                                  s_lo, s_n), 2e-3,
           "h_matmul moments")
