"""The segment-sum of per-entry gradient rows by Gaussian id.

Both backwards that work per entry (the tiled sampling op and the kernel
aggregation) end with it: each Gaussian's gradient is the sum of the rows of
its entries.  ``dgs_tpu`` takes ``jax.ops.segment_sum``
(``dgs_tpu/ops/sampling.py:409``).  Here the caller sorts the entries by gid
(stably) and hands the sorted order with each Gaussian's run in it;
``segment_sum`` adds each run in run order, so the result has one fixed
summation order on every device: no atomics, no ``index_add_``, two runs agree
bitwise.  A CUDA tensor launches the hand-written kernel
(``dgs_tpu_torch/csrc/segment_sum.cu``); a CPU tensor runs
``segment_sum_plain``, the same sums in the same order in plain torch.
Memory is the (P, F) output beside the operands, not a slot per possible
entry.

The rows are read through their strides and never copied: the backward
kernels write them entry-major, an (E, F) buffer handed on as its (F, E)
transpose, where an entry's F values are one contiguous record.
"""

from __future__ import annotations

import torch

from ..utils import profiling


def segment_sum_plain(rows, order, starts) -> torch.Tensor:
    """(P, F) sums: row g adds the columns ``rows[:, order[j]]`` for j in
    [starts[g], starts[g + 1]), in that order.  Step r adds every
    Gaussian's r-th column at once."""
    P = starts.shape[0] - 1
    first = starts[:-1].long()
    counts = starts[1:].long() - first
    out = rows.new_zeros((P, rows.shape[0]))
    cols = rows.T
    for r in range(int(counts.max()) if P else 0):
        live = counts > r
        out[live] += cols[order[first[live] + r]]
    return out


def segment_sum(rows, order, starts) -> torch.Tensor:
    """(P, F) fp32 sums of the columns of ``rows`` (F, E) over each
    Gaussian's run: Gaussian g sums the columns ``order[starts[g]:starts[g
    + 1]]`` in that order.  ``rows`` may be any strided view (the kernel
    reads it in place: an entry-major (E, F) buffer's transpose, or
    contiguous (F, E) rows).  ``order`` (E,) int64 is the entries' stable sort
    by gid, ``starts`` (P + 1,) int32 the first position of each gid in it;
    entries past ``starts[P]`` (gid == P, sentinels) are not read.  CUDA
    tensors launch the CUDA kernel (counted in ``segment_sum.launches``); CPU
    tensors run segment_sum_plain."""
    F, E = rows.shape
    P = starts.shape[0] - 1
    dev = rows.device
    for arg, t, dtype, shape in (("rows", rows, torch.float32, (F, E)),
                                 ("order", order, torch.int64, (E,)),
                                 ("starts", starts, torch.int32, (P + 1,))):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"segment_sum: {arg} must be a {dtype} tensor of shape "
                f"{shape} on {dev}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    if dev.type == "cpu":
        return segment_sum_plain(rows, order, starts)
    if dev.type != "cuda":
        raise ValueError(f"segment_sum: no kernel for device {dev}")
    from . import _build

    order, starts = order.contiguous(), starts.contiguous()
    out = torch.empty((P, F), dtype=torch.float32, device=dev)
    if P == 0 or F == 0:
        return out
    sf, se = rows.stride()
    lib = _build.load()
    with torch.cuda.device(dev), \
            profiling.named_scope("dgs::kernel.segment_sum"):
        err = lib.dgs_segment_sum(
            rows.data_ptr(), sf, se, F, order.data_ptr(), starts.data_ptr(),
            P, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"segment_sum: CUDA launch failed (cudaError {err})")
    segment_sum.launches += 1
    return out


segment_sum.launches = 0
