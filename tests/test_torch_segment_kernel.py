"""The segment-sum kernel itself (dgs_tpu_torch/csrc/segment_sum.cu) on the
CPU, built with g++ against the emulated CUDA runtime of cuda_emulation.py,
held bitwise against kernels.segment.segment_sum_plain in both layouts the
port hands it: contiguous feature-major (F, E) rows and the (F, E)
transpose view of an entry-major (E, F) buffer, which the backward kernels
write.  Cases: sentinel entries (gid == P, past starts[P]), Gaussians
without entries, runs longer than 32 and than the kernel's unroll, F in
{5, 9, 13} (one lane group a Gaussian of 5, 9 or 13 lanes) and F = 37 (a
group of 32 lanes over two columns each).  Then segment_sum_rows on a
strided view against the contiguous call, with the view handed on to the
kernel's wrapper uncopied."""

import ctypes

import numpy as np
import pytest
import torch

from dgs_tpu_torch.kernels import segment
from dgs_tpu_torch.ops import sampling as tsampling

import cuda_emulation

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def kernel(tmp_path_factory):
    (lib,) = cuda_emulation.build(tmp_path_factory.mktemp("segment_emulated"),
                                  ["segment_sum"])
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dgs_segment_sum.argtypes = [p, ll, ll, i, p, p, i, p, p]
    return lib


def run_kernel(lib, rows, order, starts):
    """The emulated kernel on ``rows`` (F, E), read through its strides."""
    F = rows.shape[0]
    P = starts.shape[0] - 1
    out = torch.full((P, F), float("nan"))
    sf, se = rows.stride()
    assert lib.dgs_segment_sum(
        ctypes.c_void_p(rows.data_ptr()), sf, se, F,
        ctypes.c_void_p(order.data_ptr()), ctypes.c_void_p(starts.data_ptr()),
        P, ctypes.c_void_p(out.data_ptr()), None) == 0
    return out


def operands(seed, P, F, E, long_runs=False):
    """Seeded rows (F, E) and gids with sentinels, Gaussians 3-6 without
    entries and (``long_runs``) Gaussians 0 and 1 with runs of 70 and 33
    entries; the order and starts segment_sum_rows would build."""
    rng = np.random.default_rng(seed)
    gid = rng.integers(0, P + 1, E)
    gid[rng.random(E) < 0.1] = P                   # more sentinels
    gid[(gid >= 3) & (gid <= 6)] = P                # no entries
    if long_runs:
        gid[(gid == 0) | (gid == 1)] = P
        pick = rng.choice(E, 103, replace=False)
        gid[pick[:70]] = 0
        gid[pick[70:]] = 1
    gid = torch.from_numpy(gid.astype(np.int32))
    rows = torch.from_numpy(rng.normal(size=(F, E)).astype(np.float32))
    g_sorted, order = torch.sort(gid, stable=True)
    starts = torch.searchsorted(
        g_sorted, torch.arange(P + 1, dtype=g_sorted.dtype), out_int32=True)
    return rows, gid, order, starts


@pytest.mark.parametrize("layout", ["feature_major", "entry_major"])
@pytest.mark.parametrize("F", [5, 9, 13, 37])
def test_kernel_matches_plain_bitwise(kernel, F, layout):
    """The kernel against segment_sum_plain, bitwise, on 60 Gaussians with
    sentinels, empty runs and runs of 70 and 33 entries; the entry-major
    rows are a transpose view, read in place."""
    P, E = 60, 900
    rows, _, order, starts = operands(F, P, F, E, long_runs=True)
    counts = torch.diff(starts)
    assert int(counts[0]) == 70 and int(counts[1]) == 33
    assert not counts[3:7].any() and int(starts[-1]) < E
    if layout == "entry_major":
        rows = rows.T.contiguous().T
        assert rows.stride() == (1, F)
    got = run_kernel(kernel, rows, order, starts)
    want = segment.segment_sum_plain(rows, order, starts)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert not got[3:7].any()
    again = run_kernel(kernel, rows, order, starts)
    assert torch.equal(got, again)


def test_kernel_adds_in_run_order(kernel):
    """A run whose sum depends on the order of its adds (1e8, 1, -1e8 and
    their permutations): the kernel adds in run order, as the plain
    version, in both layouts."""
    vals = np.array([1e8, 1.0, -1e8, 3.0, 1.0, -3.0, 0.5, 2e7, -2e7],
                    np.float32)
    E = vals.shape[0]
    rows = torch.from_numpy(np.stack([vals, vals[::-1].copy(), 2 * vals]))
    order = torch.tensor([2, 0, 1, 5, 4, 3, 8, 6, 7])
    starts = torch.tensor([0, 3, 3, 9], dtype=torch.int32)
    want = segment.segment_sum_plain(rows, order, starts)
    for r in (rows, rows.T.contiguous().T):
        got = run_kernel(kernel, r, order, starts)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    ref = np.zeros(3, np.float32)
    for j in range(3):
        ref = ref + rows[:, order[j]].numpy()
    np.testing.assert_array_equal(want[0].numpy(), ref)
    assert not want[1].any() and E == 9


@pytest.mark.parametrize("F", [5, 13])
def test_segment_sum_rows_takes_the_view_uncopied(monkeypatch, F):
    """segment_sum_rows on the transpose view of an entry-major buffer
    equals the call on contiguous rows bitwise, and the wrapper hands the
    view itself (same storage, same strides) to the kernel's plain
    version."""
    P = 40
    rows, gid, _, _ = operands(100 + F, P, F, 500, long_runs=True)
    view = rows.T.contiguous().T
    seen = []
    plain = segment.segment_sum_plain

    def spy(r, order, starts):
        seen.append((r.data_ptr(), r.stride()))
        return plain(r, order, starts)

    monkeypatch.setattr(segment, "segment_sum_plain", spy)
    got = tsampling.segment_sum_rows(view, gid, P, slots=100)
    want = tsampling.segment_sum_rows(rows, gid, P, slots=100)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert seen[0] == (view.data_ptr(), (1, F))
    assert seen[1] == (rows.data_ptr(), (500, 1))
