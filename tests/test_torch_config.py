"""dgs_tpu_torch.config against dgs_tpu.config, and the port's import
boundary (torch and numpy only, never JAX)."""

import dataclasses
import subprocess
import sys
import os

import pytest
import torch

import dgs_tpu.config as jcfg
import dgs_tpu_torch.config as tcfg

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_sampler_config_fields_and_defaults_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(jcfg.SamplerConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tcfg.SamplerConfig)]
    assert tf == jf


@pytest.mark.parametrize("kw", [
    {},
    {"tile_size": 0.051},
    {"tile_size": 0.1275},
    {"tile_size": 0.25},
    {"tile_size": 0.3, "period": 3.0},
    {"period": None, "upper_bounds": (1.0, 2.0), "tile_size": 0.3},
    {"period": None, "lower": (0.0, -1.0, -2.0),
     "upper_bounds": (1.0, 1.0, 1.0), "tile_size": 0.2},
])
def test_derived_values_match(kw):
    j, t = jcfg.SamplerConfig(**kw), tcfg.SamplerConfig(**kw)
    assert t.tile_size == j.tile_size      # the periodic snap
    assert t.grid_shape() == j.grid_shape()
    assert t.upper == j.upper
    assert t.bwd_blocks == j.bwd_blocks
    assert t.D == j.D
    for D in (1, 2, 3):
        jd, td = j.with_dims(D), t.with_dims(D)
        assert (td.lower, td.upper_bounds, td.grid_shape()) == (
            jd.lower, jd.upper_bounds, jd.grid_shape())


def test_helpers_match():
    assert tcfg.ORDERS == jcfg.ORDERS
    for D in (1, 2, 3):
        assert tcfg.tri_size(D) == jcfg.tri_size(D)
        for i in range(D):
            for j in range(D):
                assert tcfg.tri_index(D, i, j) == jcfg.tri_index(D, i, j)
        for order in jcfg.ORDERS:
            assert tcfg.n_components(order, D) == jcfg.n_components(order, D)
            assert (tcfg.out_shape(order, 7, D, 3)
                    == jcfg.out_shape(order, 7, D, 3))


@pytest.mark.parametrize("flag,value", [
    ("separable_kernels", True), ("moment_backward", True),
    ("fast_math_dots", True), ("work_span_fwd", 2), ("work_span_bwd", 2),
    ("folded_values", True), ("folded_dvals", True), ("folded_vjp", True),
    ("h_matmul", True),
])
def test_ported_modes_are_accepted(flag, value):
    """Every kernel mode of dgs_tpu (the separable forward, the moment-form
    backward, fast_math_dots, the folded forward, the folded dvalues, the
    folded VJP, h_matmul) and the span scheduling knobs of the TPU work
    list: accepted, held as given, and the config otherwise dgs_tpu's."""
    t = tcfg.SamplerConfig(**{flag: value})
    j = jcfg.SamplerConfig(**{flag: value})
    assert getattr(t, flag) == value
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_import_leaves_jax_out():
    code = ("import sys, dgs_tpu_torch, dgs_tpu_torch.models.pigs, "
            "dgs_tpu_torch.utils.native, dgs_tpu_torch.kernels._build, "
            "dgs_tpu_torch.kernels.dense, dgs_tpu_torch.kernels.tiled, "
            "dgs_tpu_torch.ops.sampling, dgs_tpu_torch.oracle.dense, "
            "dgs_tpu_torch.ops.aggregation, dgs_tpu_torch.kernels.aggregate, "
            "dgs_tpu_torch.models.dynamics, dgs_tpu_torch.ops.sampling_chunked, "
            "dgs_tpu_torch.utils.checkpoint, dgs_tpu_torch.utils.debug, "
            "dgs_tpu_torch.utils.metrics, dgs_tpu_torch.utils.profiling, "
            "dgs_tpu_torch.utils.roofline, chip_smoke; "
            "bad = [m for m in sys.modules "
            "if m == 'jax' or m.startswith(('jax.', 'dgs_tpu.'))"
            " or m == 'dgs_tpu']; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
