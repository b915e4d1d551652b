"""dgs_tpu_torch's segment-sum of per-entry gradient rows by Gaussian id
(ops.sampling.segment_sum_rows over kernels.segment.segment_sum) against a
numpy replica that adds each Gaussian's entries one at a time in entry
order, in float32: bitwise equal, with sentinel entries (gid == P),
Gaussians without entries and a D = 3 binning with R = 8."""

import numpy as np
import pytest
import torch

from dgs_tpu_torch.binning import grid as tgrid
from dgs_tpu_torch.config import SamplerConfig
from dgs_tpu_torch.kernels import segment
from dgs_tpu_torch.ops import sampling as tsampling

from conftest import make_gaussians, make_samples

torch.set_num_threads(2)


def replica(rows, gid, P):
    """(P, F) float32: Gaussian g adds the columns of its entries in entry
    order, starting from zero; gid == P is dropped."""
    out = np.zeros((P, rows.shape[0]), np.float32)
    for e, g in enumerate(gid):
        if g < P:
            out[g] = out[g] + rows[:, e]
    return out


def test_segment_sum_matches_replica_with_sentinels_and_empty(rng):
    P, F, E = 50, 7, 400
    gid = rng.integers(0, P + 1, E).astype(np.int32)
    gid[gid % 7 == 3] = P                     # more sentinels
    gid[(gid >= 10) & (gid < 15)] = P          # Gaussians 10-14: no entries
    rows = rng.normal(size=(F, E)).astype(np.float32)
    got = tsampling.segment_sum_rows(torch.from_numpy(rows),
                                     torch.from_numpy(gid), P, slots=E)
    want = replica(rows, gid, P)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not want[10:15].any()


def test_segment_sum_of_a_d3_binning_with_r8(rng):
    """The entries of a D = 3 binning with max_tiles_per_gaussian 8 (slots
    8^3 = 512 a Gaussian, the bound the R^D slot layout allocated): the
    tiled backward's row count (D + tri + C = 13), sentinel pad entries."""
    P, D, C = 40, 3, 4
    m, _, cov, _ = make_gaussians(rng, P, D, C, sigma_range=(0.05, 0.2))
    s = make_samples(rng, 300, D)
    cfg = SamplerConfig(tile_size=0.2, max_tiles_per_gaussian=8,
                        entry_capacity_factor=400.0).with_dims(D)
    state = tgrid.build(cfg, *map(torch.from_numpy, (m, cov, s)))
    assert int(state.overflow) == 0 and int(state.entry_overflow) == 0
    gid = state.ent_gid.numpy()
    counts = np.bincount(gid[gid < P], minlength=P)
    assert (gid == P).any() and counts.max() > 8
    rows = rng.normal(size=(13, gid.shape[0])).astype(np.float32)
    got = tsampling.segment_sum_rows(torch.from_numpy(rows), state.ent_gid,
                                     P, slots=8 ** D)
    np.testing.assert_array_equal(got.numpy(), replica(rows, gid, P))
    again = tsampling.segment_sum_rows(torch.from_numpy(rows), state.ent_gid,
                                       P, slots=8 ** D)
    assert torch.equal(got, again)


def test_segment_sum_plain_adds_runs_in_order(rng):
    """segment_sum (the plain version on the CPU) over a given order and
    runs: Gaussian g adds columns order[starts[g]:starts[g + 1]] in that
    order; columns past starts[P] are not read."""
    F, E = 3, 30
    rows = rng.normal(size=(F, E)).astype(np.float32)
    order = rng.permutation(E)
    starts = np.array([0, 4, 4, 11, 25], np.int32)        # P = 4, run 1 empty
    got = segment.segment_sum(torch.from_numpy(rows),
                              torch.from_numpy(order),
                              torch.from_numpy(starts))
    want = np.zeros((4, F), np.float32)
    for g in range(4):
        for j in range(starts[g], starts[g + 1]):
            want[g] = want[g] + rows[:, order[j]]
    np.testing.assert_array_equal(got.numpy(), want)


def test_segment_sum_checks_its_operands():
    rows = torch.zeros((2, 5))
    order = torch.arange(5)
    starts = torch.tensor([0, 2, 5], dtype=torch.int32)
    with pytest.raises(ValueError, match="starts"):
        segment.segment_sum(rows, order, starts.long())
    with pytest.raises(ValueError, match="order"):
        segment.segment_sum(rows, order[:4], starts)
    with pytest.raises(ValueError, match="rows"):
        segment.segment_sum(rows.double(), order, starts)
