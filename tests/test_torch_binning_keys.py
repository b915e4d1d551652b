"""The binning's key kernel (dgs_tpu_torch/csrc/binning_keys.cu) against
binning.grid.candidate_keys_plain, its plain version.

On the CPU: the wrapper's checks; CPU tensors take the plain body and
launch nothing; and the kernel itself, built with g++ against the
emulated CUDA runtime of cuda_emulation.py, bitwise against the plain body
(D = 1-3, periodic and open, (P,) and (P, D) radii, with and without the
ellipsoid cull, full-cover, empty and degenerate rows, R = 1 to 5, the
over-31-bit key).  There the tiles are powers of two: the plain body divides
a CPU tensor by the tile, while torch on the card, and so the kernel,
multiplies by its float32 reciprocal, and the two agree where the
reciprocal is exact.

On the card (marker ``card``; run there with ``python -m pytest
--noconftest -m card tests/test_torch_binning_keys.py``, which leaves out
conftest.py's JAX set-up): duplicate_entries through the kernel against
duplicate_entries through the plain body on the same CUDA tensors, every
output bitwise equal, at the cases above, at rects on the border between
the reciprocal and the quotient, and at tools.bench's D = 3 workload at full
size.  This file imports no JAX."""

import ctypes

import numpy as np
import pytest
import torch

from dgs_tpu_torch.binning import grid
from dgs_tpu_torch.config import SamplerConfig
from dgs_tpu_torch.models.field import init_field
from dgs_tpu_torch.oracle.dense import radii as iso_radii, radii_axis

import cuda_emulation

torch.set_num_threads(2)

DOMAINS = {
    "periodic": dict(period=2.0, lower=(-1.0,)),
    "open": dict(period=None, lower=(-1.0,), upper_bounds=(1.0,)),
}


def config(D, domain, tile, axis, cull, R=4):
    kw = DOMAINS[domain]
    kw = {k: (v * D if isinstance(v, tuple) else v) for k, v in kw.items()}
    return SamplerConfig(tile_size=tile, radius_sigma=3.0, eig_floor=1e-12,
                         max_tiles_per_gaussian=R, axis_radii=axis,
                         ellip_cull=cull, **kw).with_dims(D)


def operands(cfg, P, D, seed, sigma, dev="cpu"):
    """Seeded (means, radii, conics) of the config's kind, every other
    Gaussian elongated (a scale ratio of about 6, rotated, so the cull's
    sweeps matter), with a full-cover row (0), an empty row (1), a
    degenerate row (2: zero conic) and a row on a tile corner (3)."""
    gen = torch.Generator().manual_seed(seed)
    field = init_field(gen, P, D, 1, sigma=sigma)
    with torch.no_grad():
        field.log_scales[::2, 0] += 1.2
        field.log_scales[::2, -1] -= 0.6
        means = field.means.detach().clone()
        cov = field.covariances()
        conics = field.conics().clone()
    fn = radii_axis if cfg.axis_radii else iso_radii
    radii = fn(cov, D, cfg.radius_sigma, cfg.eig_floor).clone()
    radii[0] = 3.0
    radii[1] = 0.0
    conics[2] = 0.0
    means[3] = cfg.lower[0] + 3 * cfg.tile_size
    return tuple(t.contiguous().to(dev) for t in (means, radii, conics))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


# ---------------------------------------------------------------- CPU ----

def test_wrapper_checks_its_operands():
    cfg = config(3, "periodic", 0.25, True, True)
    m, r, c = operands(cfg, 16, 3, 0, 0.1)
    bad = [
        ((m.double(), r, c), "means"),
        ((m[:, :2].contiguous(), r, c), "radii"),
        ((torch.zeros(16, 4), r, c), "means"),
        ((m, r.double(), c), "radii"),
        ((m, r[:, :2], c), "radii"),
        ((m, r[:8], c), "radii"),
        ((m, r, c[:, :3]), "conics"),
        ((m, r, c.half()), "conics"),
        ((m, r.to("meta"), c), "radii"),
        ((m, r, c.to("meta")), "conics"),
    ]
    for args, name in bad:
        with pytest.raises(ValueError, match=name):
            grid.candidate_keys(cfg, args[0], args[1], 4, args[2])
    with pytest.raises(ValueError, match="R must"):
        grid.candidate_keys(cfg, m, r, 0, c)
    meta = tuple(t.to("meta") for t in (m, r, c))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        grid.candidate_keys(cfg, *meta[:2], 4, meta[2])


@pytest.mark.parametrize("D", [1, 2, 3])
def test_cpu_takes_the_plain_body(D):
    """CPU tensors run candidate_keys_plain and launch nothing, alone or
    inside duplicate_entries."""
    cfg = config(D, "periodic", 0.2, True, True)
    m, r, c = operands(cfg, 40, D, D, 0.08)
    launches = grid.candidate_keys.launches
    got = grid.candidate_keys(cfg, m, r, 4, c)
    grid.duplicate_entries(cfg, m, r, 4, 40 * 4 ** D, conics=c)
    want = grid.candidate_keys_plain(cfg, m, r, 4, c)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        assert torch.equal(a, b)
    assert grid.candidate_keys.launches == launches


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    (lib,) = cuda_emulation.build(tmp_path_factory.mktemp("keys_emulated"),
                                  ["binning_keys"])
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ip, fp = ctypes.POINTER(i), ctypes.POINTER(f)
    lib.dgs_binning_keys.argtypes = [
        p, p, i, p, i, i, i, ip, ip, fp, f, f, i, f, i, i, i, p, p, p]
    lib.dgs_binning_keys.restype = i
    return lib


def run_emulated(lib, cfg, means, radii, R, conics):
    P, D = means.shape
    out = torch.full((P * R ** D,), -7, dtype=torch.int32)
    overflow = torch.zeros((), dtype=torch.int32)
    assert grid.launch_keys(lib, cfg, means, radii, R, conics, out,
                            overflow, None) == 0
    return out, overflow


def check_emulated(lib, cfg, P, D, R, seed, sigma, cull=True):
    m, r, c = operands(cfg, P, D, seed, sigma)
    c = c if cull else None
    got = run_emulated(lib, cfg, m, r, R, c)
    want = grid.candidate_keys_plain(cfg, m, r, R, c)
    assert torch.equal(got[0], want[0])
    assert int(got[1]) == int(want[1])
    T = grid.num_tiles(cfg, D)
    tiles = (want[0] >> int(P).bit_length() if grid.key_packed(P, T)
             else want[0])
    return tiles, T, int(want[1])


@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("axis", [True, False])
@pytest.mark.parametrize("domain", sorted(DOMAINS))
@pytest.mark.parametrize("D", [1, 2, 3])
def test_emulated_kernel_matches_plain(emulated, D, domain, axis, cull):
    """Keys and rect overflow bitwise, with kept and dropped candidates
    both present."""
    cfg = config(D, domain, 0.25, axis, cull)
    tiles, T, _ = check_emulated(emulated, cfg, 150, D, 4, 10 * D, 0.05,
                                 cull)
    assert (tiles < T).any() and (tiles == T).any()


@pytest.mark.parametrize("R", [1, 2, 3, 4, 5])
def test_emulated_kernel_every_rect_cap(emulated, R):
    """R from 1 (most rects overflow) to 5 (none but the full cover)."""
    cfg = config(3, "periodic", 0.125, True, True, R)
    _, _, over = check_emulated(emulated, cfg, 90, 3, R, R, 0.03)
    assert over >= 1


def test_emulated_kernel_unpacked_tiles(emulated):
    """256^3 tiles and 100 Gaussians: 25 + 7 bits, so tiles, not keys."""
    cfg = config(3, "periodic", 2.0 / 256, False, True, 2)
    assert not grid.key_packed(100, grid.num_tiles(cfg, 3))
    tiles, T, _ = check_emulated(emulated, cfg, 100, 3, 2, 5, 0.004)
    assert (tiles < T).any()


# --------------------------------------------------------------- card ----

def plain_duplicate_entries(monkeypatch, *args, **kw):
    """duplicate_entries with its keys from the plain body, on whatever
    device its operands are."""
    with monkeypatch.context() as mp:
        mp.setattr(grid, "candidate_keys",
                   lambda cfg, m, r, R, c=None:
                   grid.candidate_keys_plain(cfg, m, r, R, c))
        return grid.duplicate_entries(*args, **kw)


def check_card(monkeypatch, cfg, m, r, c, R, E_cap):
    """duplicate_entries through the kernel and through the plain body on
    the same CUDA tensors: ent_gid, ent_tile, ent_start and both overflow
    counts bitwise equal; the kernel launched once."""
    launches = grid.candidate_keys.launches
    got = grid.duplicate_entries(cfg, m, r, R, E_cap, conics=c)
    assert grid.candidate_keys.launches == launches + 1
    want = plain_duplicate_entries(monkeypatch, cfg, m, r, R, E_cap,
                                   conics=c)
    for name, a, b in zip(("ent_gid", "ent_tile", "ent_start", "overflow",
                           "entry_overflow"), got, want):
        assert a.dtype == b.dtype == torch.int32, name
        assert torch.equal(a, b), name
    flat = grid.candidate_keys(cfg, m, r, R, c)
    plain = grid.candidate_keys_plain(cfg, m, r, R, c)
    assert torch.equal(flat[0], plain[0]) and torch.equal(flat[1], plain[1])
    return got


@pytest.mark.card
@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("axis", [True, False])
@pytest.mark.parametrize("domain", sorted(DOMAINS))
@pytest.mark.parametrize("D", [1, 2, 3])
def test_card_kernel_matches_plain(card, monkeypatch, D, domain, axis,
                                   cull):
    """5,000 Gaussians at tile 0.2, R = 4, once untruncated and once cut to
    a third of the candidates."""
    cfg = config(D, domain, 0.2, axis, cull)
    m, r, c = operands(cfg, 5000, D, 100 + D, 0.06, card)
    c = c if cull else None
    got = check_card(monkeypatch, cfg, m, r, c, 4, 5000 * 4 ** D)
    assert int(got[3]) >= 1
    kept = int((got[1] < grid.num_tiles(cfg, D)).sum())
    got = check_card(monkeypatch, cfg, m, r, c, 4, kept // 2)
    assert int(got[4]) == kept - kept // 2


@pytest.mark.card
@pytest.mark.parametrize("R", [1, 2, 3, 4, 5])
def test_card_every_rect_cap(card, monkeypatch, R):
    cfg = config(3, "periodic", 0.2, True, True, R)
    m, r, c = operands(cfg, 5000, 3, 200 + R, 0.05, card)
    check_card(monkeypatch, cfg, m, r, c, R, 5000 * R ** 3)


@pytest.mark.card
def test_card_unpacked_tiles(card, monkeypatch):
    """Tiles of 2 / 256 and 5,000 Gaussians: 25 + 13 bits, the stable
    sort of tiles."""
    cfg = config(3, "periodic", 2.0 / 256, True, True, 3)
    assert not grid.key_packed(5000, grid.num_tiles(cfg, 3))
    m, r, c = operands(cfg, 5000, 3, 7, 0.004, card)
    check_card(monkeypatch, cfg, m, r, c, 3, 5000 * 27)


def reciprocal_borders(tile):
    """Every float32 x in [1, 2) where floor or ceil of x times the float32
    reciprocal of ``tile`` differs from floor or ceil of the float32
    quotient x / tile."""
    x = (np.arange(1 << 23, dtype=np.uint32)
         | np.uint32(0x3F800000)).view(np.float32)
    t = np.float32(tile)
    prod, quot = x * (np.float32(1.0) / t), x / t
    return x[(np.floor(prod) != np.floor(quot))
             | (np.ceil(prod) != np.ceil(quot))]


@pytest.mark.card
@pytest.mark.parametrize("tile", [0.3, 0.15, 0.1])
def test_card_rects_use_the_reciprocal(card, monkeypatch, tile):
    """Rects at the offsets x (of the mean from the lower corner) where the
    reciprocal's product and the quotient round to different tiles, 512
    Gaussians each: torch on the card, and so the kernel, takes the
    product."""
    x = np.repeat(reciprocal_borders(tile), 512)
    assert x.size, "no offset separates the product from the quotient"
    cfg = config(3, "open", tile, True, True)
    xt = torch.from_numpy(x).to(card)
    # torch's own division on the card: the product with the reciprocal.
    inv = np.float32(1.0) / np.float32(tile)
    assert torch.equal(torch.floor(xt / tile).cpu(),
                       torch.from_numpy(np.floor(x * inv)))
    P = x.size
    m = (xt - 1.0)[:, None].expand(P, 3).contiguous()   # m - lower == x
    r = torch.full((P, 3), 1e-30, device=card)
    c = torch.tensor([[1.0, 0.0, 0.0, 1.0, 0.0, 1.0]],
                     device=card).expand(P, 6).contiguous()
    check_card(monkeypatch, cfg, m, r, c, 4, P * 64)


@pytest.mark.card
@pytest.mark.parametrize("R", [4, 5])
def test_card_bench_workload(card, monkeypatch, R):
    """The D = 3 workload of tools.bench at full size (100k Gaussians of
    init_field, 1M samples, tile 0.2, axis radii, the cull), planned, at R =
    4 and 5 under the plan's entry capacity: the keys and every output
    bitwise equal."""
    from dgs_tpu_torch.tools import bench

    s = bench.settings({"BENCH_D": "3"})
    field, samples = bench.field_and_samples(s["P"], s["N"], 3, s["C"],
                                             s["sigma"], card, seed=R)
    w = bench.plan(bench.config(s), s["method"], field, samples,
                   s["orders"])
    cfg, means, rad, con, _, E_cap = bench.entry_operands(w)
    P = means.shape[0]
    assert P == 100_000 and con is not None and rad.shape == (P, 3)
    check_card(monkeypatch, cfg, means, rad, con, R,
               min(P * R ** 3, E_cap))
