"""The plain reference against the port's CPU path at a small size: the
frozen pair rule bitwise, outputs and gradients; and the reference's own
independence from the port."""

import math
import subprocess
import sys

import pytest
import torch

from conftest import ROOT

ORDERS3 = ("value", "derivative", "laplacian")
ORDERS4 = ORDERS3 + ("third",)


def field(P, N, C, sigma, seed, D=3):
    g = torch.Generator().manual_seed(seed)
    means = 2 * torch.rand((P, D), generator=g) - 1
    ls = math.log(sigma) + 0.2 * torch.randn((P, D), generator=g)
    rot = (torch.randn((P, 4), generator=g) if D == 3
           else 2 * math.pi * torch.rand((P, 1), generator=g))
    vals = 0.1 * torch.randn((P, C), generator=g)
    x = 2 * torch.rand((N, D), generator=g) - 1
    return means, ls, rot, vals, x


def tiles_config(D, tile, per_axis=True, cull=True):
    return {"D": D, "period": 2.0, "lower": -1.0, "tile": tile,
            "radius_sigma": 3.0, "eig_floor": 1e-12, "axis_radii": per_axis,
            "ellip_cull": cull, "pair_rule": "tiles"}


@pytest.mark.parametrize("D,seed,per_axis,cull", [
    (3, 0, True, True), (3, 1, True, True), (2, 2, True, True),
    (2, 3, False, False), (3, 4, False, True)])
def test_tile_rule_matches_program_binning(D, seed, per_axis, cull):
    from dgs_tpu_torch.binning import grid as bg
    from dgs_tpu_torch.config import SamplerConfig
    from dgs_tpu_torch.models.field import GaussianField
    from dgs_tpu_torch.ops import sampling_chunked as sc

    from bench_port.reference import pairs as rp

    tile = 0.4 if D == 3 else 0.1
    means, ls, rot, vals, x = field(500, 3000, 2, 0.08 if D == 3 else 0.03,
                                    seed, D)
    f = GaussianField(means, ls, rot, vals)
    cfg = SamplerConfig(tile_size=tile, max_tiles_per_gaussian=3,
                        eig_floor=1e-12, axis_radii=per_axis,
                        ellip_cull=cull)
    with torch.no_grad():
        cov, con = f.covariances(), f.conics()
        cfg2, plan = sc.plan_chunked(cfg, f.means, cov, x)
        rad = sc._radii(cfg2, cov, D)
        gid, tile_, _, _, _ = bg.duplicate_entries(
            cfg2, f.means, rad, plan.rect, 500 * plan.rect ** D,
            conics=con if cull else None)
    rule = rp.rule_of(tiles_config(D, tile, per_axis, cull))
    R = rp.extent(rule, means, ls, rot)
    assert R == plan.rect
    ents = rp.entries(rule, means, ls, rot, R, rows=97)
    T = rule.grid.tiles
    assert torch.equal(ents.tile.int(), tile_[tile_ < T])
    assert torch.equal(ents.gid.int(), gid[tile_ < T])
    assert torch.equal(rp.sample_tiles(rule.grid, x),
                       bg.sample_tiles(cfg2, x))


@pytest.mark.parametrize("D", [3, 2])
def test_outputs_and_gradients_match_chunked_path(D):
    from dgs_tpu_torch.config import SamplerConfig
    from dgs_tpu_torch.models.field import GaussianField
    from dgs_tpu_torch.ops import sampling_chunked as sc

    from bench_port.reference import field as rf

    tile = 0.4 if D == 3 else 0.1
    means, ls, rot, vals, x = field(300, 3000, 2, 0.08 if D == 3 else 0.03,
                                    3, D)
    f = GaussianField(means.clone(), ls.clone(), rot.clone(), vals.clone())
    cfg = SamplerConfig(tile_size=tile, max_tiles_per_gaussian=3,
                        eig_floor=1e-12, axis_radii=True, ellip_cull=True)
    with torch.no_grad():
        cfg2, plan = sc.plan_chunked(cfg, f.means, f.covariances(), x)
    cs = sc.chunk_samples(cfg2, x, plan, cfg2.block_n)
    outs, _ = sc.sample_chunked(cfg2, f.means, f.values, f.conics(),
                                f.covariances(), x, plan, cs, ORDERS3)
    config = tiles_config(D, tile)
    ref = rf.outputs(config, ORDERS3, (means, ls, rot), vals, x, None)
    for o in ORDERS3:
        err = (outs[o].detach().double() - ref[o]).abs().max()
        assert err <= 2e-6 * ref[o].abs().max(), o
    pick = torch.tensor([5, 17, 2999, 0])
    part = rf.outputs(config, ORDERS3, (means, ls, rot), vals, x, pick)
    for o in ORDERS3:
        assert torch.allclose(part[o], ref[o][pick], rtol=1e-12, atol=0)
    loss = sum((o * o).sum() for o in outs.values()) / x.shape[0]
    loss.backward()
    r = rf.train(config, ORDERS3, dict(means=means, log_scales=ls,
                                       rotations=rot, values=vals), x,
                 1e-3, (0.9, 0.999), 1e-8, 1)
    assert abs(float(loss) - r.losses[0]) <= 1e-6 * r.losses[0]
    for k in rf.LEAVES:
        got = float(getattr(f, k).grad.norm())
        assert abs(got - r.grads[k]) <= 1e-5 * r.grads[k], k


def test_outputs_and_gradients_match_dense_path():
    from dgs_tpu_torch.config import SamplerConfig
    from dgs_tpu_torch.models.field import GaussianField
    from dgs_tpu_torch.sampler import GaussianSampler

    from bench_port.reference import field as rf

    means, ls, rot, vals, x = field(150, 700, 4, 0.15, 4)
    f = GaussianField(means.clone(), ls.clone(), rot.clone(), vals.clone())
    s = GaussianSampler(method="pallas", config=SamplerConfig())
    s.preprocess(f.means, f.values, f.covariances(), f.conics(), x)
    outs = s.sample_all(ORDERS4)
    config = {"D": 3, "period": 2.0, "pair_rule": "all"}
    ref = rf.outputs(config, ORDERS4, (means, ls, rot), vals, x, None,
                     budget=1 << 14)
    for o in ORDERS4:
        err = (outs[o].detach().double() - ref[o]).abs().max()
        assert err <= 2e-6 * ref[o].abs().max(), o
    loss = sum((o * o).sum() for o in outs.values()) / x.shape[0]
    loss.backward()
    r = rf.train(config, ORDERS4, dict(means=means, log_scales=ls,
                                       rotations=rot, values=vals), x,
                 1e-3, (0.9, 0.999), 1e-8, 1, budget=1 << 14)
    assert abs(float(loss) - r.losses[0]) <= 1e-6 * r.losses[0]
    for k in rf.LEAVES:
        got = float(getattr(f, k).grad.norm())
        assert abs(got - r.grads[k]) <= 1e-5 * r.grads[k], k


def test_tf32_rounding():
    from bench_port.reference.gaussians import tf32

    x = torch.randn(10000, generator=torch.Generator().manual_seed(0))
    y = tf32(x)
    assert torch.all((y.view(torch.int32) & 0x1FFF) == 0)
    assert torch.all((y - x).abs() <= x.abs() * 2.0 ** -11)
    assert torch.equal(tf32(y), y)


def test_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import bench_port.reference.field, bench_port.reference.pairs\n"
            "import bench_port.reference.gaussians\n"
            "import bench_port.reference.rules.tiles\n"
            "import bench_port.reference.rules.all\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('dgs_tpu_torch', 'dgs_tpu', 'jax', 'jaxlib', 'flax'))\n"
            "print(bad)\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
