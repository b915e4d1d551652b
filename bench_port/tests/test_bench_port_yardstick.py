"""The frozen yardstick against the program's roofline module as it
stands when the benchmark was made (a test may import the port; the
benchmark's runs read only their own copy)."""

import itertools

import pytest
import torch

ORDER_SETS = [("value",), ("value", "derivative", "laplacian"),
              ("value", "derivative", "laplacian", "third"), ("third",),
              ("derivative", "laplacian")]


@pytest.mark.parametrize("D,orders,C,wrapped,backward", [
    (D, o, C, w, b) for D, o, C, w, b in itertools.product(
        (1, 2, 3), ORDER_SETS, (1, 4), (False, True), (False, True))])
def test_pair_ops_frozen(D, orders, C, wrapped, backward):
    from dgs_tpu_torch.utils import roofline

    from bench_port import yardstick

    assert yardstick.pair_ops(D, orders, C, wrapped, backward) == \
        roofline.pair_ops(D, orders, C, wrapped, backward)
    want = roofline.kernel_bound(10 ** 9, 123456, D, orders, C, wrapped,
                                 backward)["bound_ms"]
    got = 1e3 * yardstick.kernel_bound_s(10 ** 9, 123456, D, orders, C,
                                         wrapped, backward)
    assert got == pytest.approx(want, rel=1e-12)


def test_peaks_frozen():
    from dgs_tpu_torch.utils import roofline

    from bench_port import yardstick

    assert yardstick.FP32_INSTR_S == roofline.FP32_INSTR_S
    assert yardstick.MEM_BYTES_S == roofline.MEM_BYTES_S
    assert yardstick.SFU_OPS_S == roofline.SFU_OPS_S


def test_pair_count_matches_program_binning():
    from dgs_tpu_torch.binning import grid as bg
    from dgs_tpu_torch.config import SamplerConfig
    from dgs_tpu_torch.models.field import GaussianField
    from dgs_tpu_torch.ops import sampling_chunked as sc
    from dgs_tpu_torch.utils import roofline

    import conftest
    from bench_port import harness, inputs
    from bench_port.reference import field as ref_field

    c = harness.cell_spec(harness.benchmark(), "d3_chunked.train3")
    cfg = {**c["config"], **conftest.small("d3_chunked.train3")}
    x = inputs.make(cfg, c["traffic"], 9, torch.device("cpu"))
    geometry = tuple(x[k] for k in inputs.LEAVES[:3])
    plan = ref_field.rule(cfg).plan(cfg, geometry)
    w = harness.work({"config": cfg}, x, plan)
    f = GaussianField(*(x[k] for k in inputs.LEAVES))
    base = SamplerConfig(tile_size=cfg["tile"], max_tiles_per_gaussian=3,
                         eig_floor=1e-12, axis_radii=True, ellip_cull=True)
    with torch.no_grad():
        cov, con = f.covariances(), f.conics()
        scfg, cplan = sc.plan_chunked(base, f.means, cov, x["samples"])
        _, tile, _, _, _ = bg.duplicate_entries(
            scfg, f.means, sc._radii(scfg, cov, 3), cplan.rect,
            cfg["P"] * cplan.rect ** 3, conics=con)
    assert plan == cplan.rect
    T = bg.num_tiles(scfg, 3)
    assert w["pairs"] == roofline.pair_count(
        tile, T, bg.sample_tiles(scfg, x["samples"]))
    assert w["entries"] == int((tile < T).sum())
