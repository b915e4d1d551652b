"""On-card smoke run of the PyTorch + CUDA port (dgs_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py            # everything below
    python3 chip_smoke.py --tiled    # the two tiled kernels' and the tiled
                                     # steps' times only (see tiled_times)
    python3 chip_smoke.py --dense    # the two dense kernels' and the dense
                                     # steps' times and the segment-sum's
                                     # memory only (see dense_times)
    python3 chip_smoke.py --agg      # the aggregation kernels' and the
                                     # aggregation and dynamics steps' times
                                     # only (see agg_times)
    python3 chip_smoke.py --segment  # the segment-sum's times on every
                                     # path's rows only (see segment_times)
    python3 chip_smoke.py --chunked  # the chunked path's kernels' and
                                     # steps' times only (see
                                     # chunked_times)
    python3 chip_smoke.py --sharded  # the two sharded phases only (see
                                     # sharded_times)
    python3 chip_smoke.py --tools    # the measuring tools' phase only (see
                                     # phase_tools)
    python3 chip_smoke.py --modes    # the kernel modes' two phases only
                                     # (parity_modes, modes_slice)
    python3 chip_smoke.py --folded   # the folded modes' and h_matmul's
                                     # two phases only (parity_folded,
                                     # folded_slice)
    python3 chip_smoke.py --binning  # the binning's key kernel against its
                                     # plain chain, its times and its
                                     # ptxas and SASS counts only (see
                                     # binning_times)

Several modes may be given; they run in the order given.  The per-pair
operation counts and the card's peak rates of the bounds are
dgs_tpu_torch.utils.roofline's; device busy time is
dgs_tpu_torch.utils.profiling.device_busy.

Phases, one JSON line each (any failure raises and exits non-zero):

  1. device      - torch and CUDA versions, the card's name and power limit.
  2. build       - builds the CUDA kernel library (one nvcc per source, in
                   parallel, sm_90a) and the host capacity planner (g++) from
                   the sources; seconds and the ptxas register / spill
                   report.  An aggregation kernel that spills fails the
                   whole run (not the --tiled, --dense and --agg modes).
  3. parity      - the tiled forward CUDA kernel against its plain torch
                   version on the same operands: D in {1, 2, 3}, all four
                   orders, wrapped and unwrapped, C in {1, 2, 3, 4, 6} (the
                   channel passes of 1, 2 and 4, and two passes), full-cover
                   (wide) Gaussians, and a case whose tiles partly hold no
                   samples or no entries, at P = 5,000 x N = 50,000 (16 tiles
                   an axis: warps that straddle 2 to tens of tiles, ranges
                   that start at any offset); pad columns exactly zero; and
                   the facade against the dense masked oracle on a small
                   input.
     parity_bwd  - the tiled backward CUDA kernel against its plain version
                   on the same operands and a random cotangent: D in
                   {1, 2, 3} x wrapped/unwrapped x C in {1, 4, 6}, all four
                   orders, plus C = 2, the wide case, a non-canonical order
                   set, the order sets the trainers launch and the case with
                   empty tiles; sentinel columns exactly zero; then the op's
                   gradients on the card against autograd through the dense
                   masked oracle (twice, bitwise equal).
     parity_paths - both tiled kernels against their plain versions on the
                   operands that PIGS config 4's two evaluations (value +
                   laplacian and value, C = 1, wrapped) and the dynamics
                   step's evaluation (value, C = 2) give them at full width,
                   taken from the autograd graph of one loss of each path:
                   the instantiations those paths launch (pass width 1 and 2,
                   the scaled wrap); pad and sentinel columns exactly zero;
                   the kernels' times and bounds at those shapes, and the
                   segment-sum on the backward's rows there.
     parity_chunked - the chunked op (ops.sampling_chunked, planned by
                   plan_chunked) against the tiled op over its own binning
                   of the same inputs, outputs and gradients (the conics
                   taken from the covariances, so that both cull alike):
                   D in {1, 2, 3} wrapped and unwrapped, and bench.py's
                   D = 3 flags (tile 0.2, axis radii, ellipsoid cull, all
                   four orders) at P = 5,000 x N = 50,000; kernels 1-2 and
                   the segment-sum against their plain versions on the
                   chunked op's own operands; the first 512 samples of the
                   bench-flag case against the dense masked oracle.
     parity_modes - the kernel modes of kernels 1-2 (the separable forward,
                   csrc/tiled_forward_sep.cu; the moment-form backward,
                   csrc/tiled_backward_moments.cu) against their plain
                   versions on wrap-free tile-local operands: D in {1, 2, 3}
                   x C in {1, 4, 6}, all four orders, full-cover footprints
                   (open box), tiles without samples or entries, C = 2; the
                   forward at 3 TF32 passes within the fp32 gate, at 1 pass
                   (outside the gate) against the 3-pass result under
                   ONE_PASS_SANITY; the backward (all orders, value only,
                   laplacian + value) within rtol 2e-3, its rows folded by
                   moment_combine against the classic backward on the same
                   operands (atol MOMENT_ATOL_REL); pad and sentinel
                   columns exactly zero; two runs bitwise equal; each
                   case's moment-form instantiation (registers, spills,
                   shared bytes, resident warps) and its 32-entry ranges
                   and blocks of ranges that straddle two tiles (counted,
                   and required).  Then
                   the op in each mode (separable, moments, both) against
                   the dense masked oracle: outputs, and gradients twice
                   and bitwise equal, with the kernels each mode launched.
     parity_folded - the folded modes of kernels 1-2 and h_matmul
                   (csrc/tiled_forward_folded.cu, tiled_backward_folded.cu,
                   tiled_backward_fvjp.cu, tiled_backward_hmm.cu,
                   tiled_backward_moments.cu's h_matmul instantiations)
                   against their plain versions on wrap-free operands: D in
                   {1, 2, 3} x C in {1, 4, 6} x three orders, four orders
                   and (value, laplacian), and D = 3 at four orders and
                   C = 4 (R = 1,092: three passes of the folded forward and
                   of the folded dvalues, several Zd windows of the folded
                   VJP; C = 6 gives R = 1,638), each case's instantiations
                   of the three folded kernels (folded_facts), blocks that
                   straddle two tiles (counted, and
                   required), full-cover footprints (open box), tiles
                   without samples or entries; the folded forward and VJP
                   within the
                   general limits or, where the expansion's cancellation
                   defeats them, within FOLD_ERR_RATIO times the fp32 plain
                   version's error against float64, the folded dvalues
                   (with and without h_matmul) too; h_matmul's backwards
                   within the general limits; 1-pass readings (outside the
                   gate; ONE_PASS_SANITY for the folded dvalues and
                   h_matmul); the folded VJP's combined rows against the
                   classic backward (FOLD_ATOL_REL); pad and sentinel
                   columns exactly zero; bitwise repeats.  Then the op in
                   each folded mode and under h_matmul against the dense
                   masked oracle, gradients twice and bitwise equal, with
                   the kernels each mode launched.
     parity_binning - the binning's key kernel (csrc/binning_keys.cu,
                   binning.candidate_keys) bitwise against
                   candidate_keys_plain, the keys and the rect overflow, on
                   the operands each main path hands it, captured from the
                   path's own call: the D = 2 headline's binning
                   (per-axis radii, no cull), the aggregation structure's
                   ((P,) radii, no conics; periodic as the path runs, and
                   the same operands in an open domain) and
                   tools.bench's D = 3 chunked workload (per-axis radii,
                   the cull; bench.entry_operands); on the last its
                   CUDA-event ms beside the plain chain's and its bound
                   (the kernels line's row).
  4. slice       - the evaluation path at full width: GaussianSampler
                   (method "tiled") preprocess + sample_all(value,
                   derivative, laplacian) at P = 100,000 Gaussians x
                   N = 1,000,000 samples, D = 2, C = 4, with capacities from
                   the host planner.  Checks the diagnostics, that the path
                   launched the forward kernel once per evaluation and the
                   backward kernel never, finite outputs, and kernel-vs-plain
                   parity on all samples; times the kernel, the plain
                   version and the path end to end.
  5. train_step  - the training step at the same width: binning, the fused
                   forward, the loss (the multiplicity-weighted sum of
                   squares of the padded, sorted, unique outputs over N) and
                   backward() to means, values and conics.  Checks the
                   diagnostics, one launch of each kernel per step, finite
                   and bitwise-reproducible gradients, the backward kernel's
                   per-entry rows against its plain version and the
                   segment-sum kernel on those rows (entry-major, as the
                   backward writes them, and feature-major) against its
                   plain version (bitwise) and index_add_; times the
                   backward kernel, its plain version and the step.
     segment     - the segment-sum at D = 3, R = 8, P = 100,000 (about 3.2 M
                   entries): its peak device memory must stay within its
                   operands and output (no P * R^D slot buffer, no copy of
                   the entry-major rows); the kernel bitwise equal to its
                   plain version there in both layouts, and on the rows of
                   a real D = 3 binning at 100,000 x 1,000,000; times of
                   the kernel, index_add_ and segment_sum_rows as a whole.
     chunked_slice - the chunked path (the JAX package's D = 3 production
                   method) at the full width of bench.py's D = 3 workload:
                   P = 100,000, N = 1,000,000, D = 3, C = 4, sigma
                   2 / P^(1/3), tile 0.2, axis radii, ellipsoid cull,
                   planned by plan_chunked, through
                   GaussianSampler(method="chunked") (preprocess,
                   evaluations) and the bench loss's training step, for
                   value + derivative + laplacian and for all four orders.
                   Checks every diagnostic 0, the launch counts (the forward
                   once per evaluation, the backward and the segment-sum
                   once per step and never in an evaluation), finite outputs
                   of the reference shapes, bitwise-repeatable gradients,
                   both kernels against their plain versions on all samples
                   (the step's own cotangent) and the segment-sum on the
                   step's rows; reports entries, pairs (utils.roofline's
                   pair_count), the plan's host time, the kernels' times
                   beside their bounds, evaluation and step times (median
                   and range), device busy time per step and peak memory.
     modes_slice - the kernel modes on the D = 3 chunked bench step at full
                   width (tools.bench at BENCH_D=3: 100,000 x 1,000,000,
                   tile 0.2, axis radii, ellipsoid cull, three orders, the
                   bench loss and its -1e-12 g step): the classic step, (a)
                   BENCH_FASTMATH=1 (both modes by the automatic default,
                   the separable contraction at 1 TF32 pass) and (b)
                   BENCH_SEP=1 BENCH_MOMENTS=1 (3 passes): host median and
                   range of 10 warm steps, the launches of those steps,
                   device busy ms, peak bytes, bitwise-repeatable
                   gradients, diagnostics 0; each step's kernels by CUDA
                   events on its own operands and cotangent (classic
                   kernels 1-2 beside the two mode kernels, with bounds,
                   the mode kernels' plain versions on (b), the moment
                   form's instantiation); (b)'s loss and
                   gradients against the classic step's within the gate,
                   (a)'s difference and its 1-pass forward against 3 passes
                   reported; then the D = 2 headline step under
                   BENCH_SEP=1 BENCH_MOMENTS=1 against the classic D = 2
                   step (the D = 2 instantiations).
  6. pigs        - PIGS training (config 4, phase A of tools/train_100k.py)
                   through dgs_tpu_torch.models.pigs.train: P = 100,000,
                   D = 2, C = 1, 262,144 collocation points, Adam lr 2e-3,
                   120 steps.  Checks overflow 0 on every logged chunk, that
                   the loss at least halves and that both kernels ran.
  7. parity_dense - the all-pairs (dense) forward CUDA kernel against its
                   plain torch version on the same operands: D in {1, 2, 3}
                   x period in {2.0, None} x C in {1, 4, 6} with all four
                   orders fused, one single-order and one non-canonical
                   order set, period 1.5 (the dividing wrap) at C in {2, 4},
                   C = 2 and the PIGS order sets at C = 1 (the narrow
                   passes), at P = 2,000 x N = 20,000, plus four sizes that
                   are no multiple of a block.
     parity_dense_bwd - the dense backward CUDA kernel against its plain
                   version on the same operands and a random cotangent, the
                   same cases, per group (means, values, conics); then the
                   op's gradients on the card against autograd through the
                   dense oracle (twice, bitwise equal).
  8. dense_slice - the all-pairs path at full width: GaussianSampler
                   (method "pallas") preprocess + sample_all of all four
                   orders at P = 10,000 Gaussians x N = 100,000 samples,
                   D = 3, C = 4, period 2.0 (10^9 pairs, 40 components),
                   then a training step at the same width (the sum of
                   squares of all outputs, backward() to means, values and
                   conics).  Checks the launch counts, finite outputs,
                   bitwise-reproducible gradients, each dense kernel against
                   its plain version (the backward on the step's own
                   cotangent) and the first 512 samples against the dense
                   oracle; times the kernels, the plain versions, the
                   evaluation and the step.
  9. pigs_dense  - PIGS training through models.pigs.train(method="pallas")
                   at P = 10,000, D = 2, C = 1, 16,384 collocation points,
                   Adam lr 2e-3, 120 steps, and the same run with
                   method="tiled" from the same seed as its control.  Both
                   losses at least halve; the dense run launches the dense
                   kernels only.
 10. parity_agg  - the three aggregation CUDA kernels (totals, forward,
                   backward) against their plain torch versions on the same
                   operands: D in {1, 2, 3} x period 2.0 / open domain x
                   ladder on / off x with and without totals, (L, K) in
                   {(1, 4), (5, 3), (8, 8)}, every 7th radius culled, plus
                   nfreq 1 and 4, L = 12 / K = 20 (above one pass) and a tile
                   range, at P = 3,000 (tail blocks); then the warp sweep's
                   edges (agg_sweep.cuh): rows with more than 32 colliding
                   pairs, tiles with one centre, 1 and 32 rows a warp
                   (kernels.aggregate.ROWS_PER_WARP set for the case), L
                   above the widest pass, nfreq 1 and 4, open and wrapped,
                   the ladder on and off, each checked present; sentinel
                   rows must come back exactly zero.
     parity_agg_oracle - aggregate_pallas through the kernels against the
                   plain torch table path over an untruncated brute-force
                   table, outputs and all six gradients (twice, bitwise
                   equal).
     parity_dynamics - the aggregation kernels against their plain versions
                   on the operands the dynamics step gives them at full
                   width (P = 100,000, sigma * 3, L = 1, K = 4, nfreq = 2,
                   the ladder recurrence), with the structure's pair counts,
                   the warp sweeps' body steps and lane use
                   (kernels.aggregate.warp_schedule) and the forward and
                   backward kernels' times, bounds and shares there, and the
                   segment-sum on the backward's entry-major rows.
 11. agg_slice   - the aggregation operating point of
                   tools/bench_aggregate.py at full width: P = 100,000,
                   D = 2, L = K = 8, nfreq = 4, through GaussianSampler
                   preprocess_aggregate(method="pallas") and
                   aggregate_neighbors.  Checks overflow 0, the launch
                   counts (totals once per structure build, forward once per
                   call, both backward kernels once per step), finite and
                   bitwise-reproducible gradients, each kernel (direct code
                   and ladder) against its plain version at full width;
                   times the structure build,
                   the forward, forward + backward, and each kernel beside
                   its plain version (and the ladder path's kernels).
 12. dynamics    - the dynamics trainer (config 4, phase B of
                   tools/train_100k.py) through
                   dgs_tpu_torch.models.dynamics.train: P = 100,000, D = 2,
                   rollout 2, 65,536 evaluation points, kernel aggregation,
                   tiled evaluation, frequency ladder, 60 steps.  Checks
                   overflow 0, a falling loss and the launches per step.
 13. sharded     - the sharded paths of dgs_tpu_torch/parallel/mesh.py on
                   one NCCL rank in this process, mesh (1, 1):
                   plan_sharded_config equal to the headline's plan,
                   sharded_sample_all at the headline (tiled, three
                   orders), three replicated and three model-sharded PIGS
                   steps of config 4, sharded_aggregate (forward and
                   backward) at the aggregation point over one tile-range
                   shard; each bitwise equal to its unsharded path
                   (sample_binned, pigs.train_step's losses and parameters,
                   aggregate_pallas's output and six gradients), the launch
                   counts of the whole run; then each path's time beside
                   the unsharded one's, one NCCL all-reduce's time at the
                   sizes the paths reduce, and peak memory.
     sharded_two_ranks - two processes spawned on the one card, joined
                   under gloo (NCCL takes one rank a device; gloo stages
                   CUDA tensors through host memory, its times are not
                   NCCL's), mesh (1, 2): the headline evaluation (the
                   config from plan_sharded_config), the
                   model-sharded PIGS step's gradients (not twice the
                   unsharded ones) and sharded_aggregate over two tile
                   ranges, against the unsharded paths on each rank; the
                   kernel library is built here first and the ranks load
                   it.
 14. profile     - where a step's time goes, for the headline training
                   step, the PIGS step, the dense training step, the
                   aggregation step, the dynamics step and the chunked
                   D = 3 step (three orders): device
                   busy time per step under torch.profiler (the union of
                   the device's activity intervals), the unprofiled step
                   time, the device's idle share, the device items
                   launched a step and the largest of them.
 15. tools       - every measuring tool of dgs_tpu_torch/tools through its
                   run() at its full-width defaults: bench at D = 2 and
                   D = 3, and with BENCH_METHOD=pallas (the dense kernels)
                   at dense config 2; profile_step at D = 2 and at the
                   D = 3 chunked bench workload, profile_bench, train_100k
                   at spec (300 PIGS steps, then 60 dynamics steps, with
                   its checks), bench_aggregate, profile_aggregate (step),
                   profile_dynamics (each half profiled), sweep_tile and
                   sweep_chunked over their D = 2 tile lists at 3 steps.
                   One line a record; checks the card's name and power
                   limit on every record, every diagnostic 0, profiles
                   (by kernel and by the port's function that launched
                   it) that are not empty and name the path's kernels, and
                   that each run launched the kernels of its path
                   (launches_by_path tool_*); the phase's seconds.

After modes_slice, folded_slice: the D = 3 chunked bench step (100k x 1M,
C = 4, three orders) classic, under BENCH_FOLDED=1, + BENCH_FDV=1,
+ BENCH_FVJP=1 and BENCH_HMM=1 (10 warm steps each from the same
parameters: host median and range, busy ms, device items, peak bytes, the
kernels each mode names, gradients against the classic step's at
FOLD_ATOL_REL), each new kernel's CUDA-event ms, bound and plain version
on its step's operands beside kernels 1-2, with the folded forward's,
dvalues' and VJP's registers, spills, shared bytes, resident blocks and
passes; the four-order step under BENCH_FDV=1, whose folded dvalues turn
themselves off, and the tall-R case: the folded forward, dvalues and VJP
timed on that step's four-order operands (R = 1,092); and the D = 2
headline step classic,
under the folded VJP and under h_matmul.

Then the kernels line (per kernel: launches on its main path and by path,
its time, its plain version's time, the least time the card could take
for the same work, the larger of the bytes over the memory rate and the
operations over the fp32 rate, and the share of it; for the tiled and
dense kernels also the instantiation's registers and shared memory, for
the tiled ones kept and swept pairs and the same at the trainers' shapes;
for the aggregation kernels candidate and colliding pairs, and for the
forward and backward the warp sweep's body steps and lane use at the
aggregation point; the segment-sum's row also index_add_'s time as
library_ms, both layouts and the D = 3 cases; the tiled kernels' and
the segment-sum's rows also the chunked D = 3 shapes by_shape, and
launches_by_path chunked_slice and chunked_step, sharded and
sharded_two_ranks (the two ranks' launches summed); the binning's key
kernel's row its numbers on the D = 3 chunked workload's operands from
parity_binning, with its ptxas registers and SASS instruction counts)
and, last, the result line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
The script imports no JAX and nothing of the JAX package.
"""

import contextlib
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from dgs_tpu_torch.binning import grid as binning
from dgs_tpu_torch.config import ORDERS, SamplerConfig
from dgs_tpu_torch.kernels import _build
from dgs_tpu_torch.kernels import aggregate as kagg
from dgs_tpu_torch.kernels import dense as kdense
from dgs_tpu_torch.kernels import segment
from dgs_tpu_torch.kernels import tiled as ktiled
from dgs_tpu_torch.models import dynamics, pigs
from dgs_tpu_torch.models.field import GaussianField, init_field
from dgs_tpu_torch.ops import aggregation, formulas, sampling
from dgs_tpu_torch.ops import sampling_chunked
from dgs_tpu_torch.oracle import dense as oracle
from dgs_tpu_torch.parallel import mesh as pm
from dgs_tpu_torch.sampler import GaussianSampler
from dgs_tpu_torch.tools import bench
from dgs_tpu_torch.utils import native
from dgs_tpu_torch.utils.profiling import device_busy
from dgs_tpu_torch.utils.roofline import (FP32_INSTR_S, MEM_BYTES_S,
                                          SFU_OPS_S, agg_bound,
                                          kernel_bound, mode_bound,
                                          pair_count, step_roofline)

RTOL = 2e-4          # the JAX suite's kernel-vs-oracle tolerance:
ATOL_REL = 1e-5      # atol = 1e-5 * max(1, max|ref|)
GRAD_RTOL = 2e-3     # its gradient tolerance (test_binning_tiled.py:155)
SLICE_ORDERS = ("value", "derivative", "laplacian")
HEADLINE = dict(tile_size=0.051, eig_floor=1e-12, max_tiles_per_gaussian=3,
                axis_radii=True, ellip_cull=False)


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


KERNELS = {"tiled_forward": ktiled.tiled_forward,
           "tiled_backward": ktiled.tiled_backward,
           "tiled_forward_sep": ktiled.tiled_forward_sep,
           "tiled_backward_moments": ktiled.tiled_backward_moments,
           "tiled_forward_folded": ktiled.tiled_forward_folded,
           "tiled_backward_fdv": ktiled.tiled_backward_fdv,
           "tiled_backward_fvjp": ktiled.tiled_backward_fvjp,
           "tiled_backward_hmm": ktiled.tiled_backward_hmm,
           "dense_forward": kdense.dense_forward,
           "dense_backward": kdense.dense_backward,
           "agg_totals": kagg.totals,
           "agg_forward": kagg.forward,
           "agg_backward": kagg.backward,
           "segment_sum": segment.segment_sum,
           "binning_keys": binning.candidate_keys}


def reset_launches():
    for fn in KERNELS.values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in KERNELS.items()}


def expect_launches(what, **want):
    """The kernels' launch counts since reset_launches(), raising
    unless they are ``want`` (kernels not named: 0)."""
    got = read_launches()
    if got != {name: want.get(name, 0) for name in KERNELS}:
        raise AssertionError(f"{what} launched {got}, expected {want}")
    return got


def check_close(what, got, ref, rtol, atol_rel=ATOL_REL):
    """(max abs err, max abs err / max|ref|) of got against ref, raising
    when a value is outside rtol * |ref| + atol_rel * max(1, max|ref|)."""
    scale = max(1.0, float(ref.abs().max()))
    diff = (got - ref).abs()
    bad = diff > atol_rel * scale + rtol * ref.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{what}: {int(bad.sum())} values outside the tolerance, max "
            f"abs err {float(diff.max())}")
    return (float(diff.max()),
            float(diff.max()) / max(float(ref.abs().max()), 1e-30))


def err_fields(errs):
    return {k: {"max_abs": e[0], "rel": e[1]} for k, e in errs.items()}


def compare(got, ref, orders, D, C):
    """Per-order (max abs err, max abs err / max|ref|) of the tiled
    forward's packed rows, raising when an order is outside the
    tolerance."""
    errs, k0 = {}, 0
    for order in orders:
        rows = slice(k0 * C, (k0 + formulas.n_unique(order, D)) * C)
        errs[order] = check_close(
            f"kernel against the plain version on {order}", got[rows],
            ref[rows], RTOL)
        k0 += formulas.n_unique(order, D)
    return errs


def compare_rows(got, ref, D, C, rtol=GRAD_RTOL, atol_rel=ATOL_REL):
    """Per row group (means, conics, values) of the tiled backward's packed
    (D + tri + C, Ep) rows: max abs error and max abs error / max|ref|,
    raising when a group is outside the tolerance."""
    tri = D * (D + 1) // 2
    groups = {"means": slice(0, D), "conics": slice(D, D + tri),
              "values": slice(D + tri, D + tri + C)}
    return {name: check_close(
        f"backward kernel against the plain version on {name}", got[rows],
        ref[rows], rtol, atol_rel) for name, rows in groups.items()}


def operands(state, field_tensors, samples, cfg):
    means, values, conics = field_tensors
    _, _, geom, _ = ktiled.prepare_entries(
        state, means, values, conics, ktiled.BLOCK_E, cfg=cfg)
    smp, _, Np = ktiled.prepare_samples(state, samples, ktiled.BLOCK_N)
    lo, n = ktiled.entry_ranges(state, Np)
    return geom, smp, lo, n


SPIN_MS = 1.0        # the device spins about this long before a timed call
_spin = {}           # "cycles": torch.cuda._sleep's argument for SPIN_MS


def spin_cycles():
    """The cycle count that makes torch.cuda._sleep (PyTorch's own test
    helper: a kernel that spins for that many device clock cycles) hold the
    device for about SPIN_MS, from one spin of 10^6 cycles timed with CUDA
    events after a warm-up; measured once a process."""
    if "cycles" not in _spin:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize()
        a.record()
        torch.cuda._sleep(1_000_000)
        b.record()
        b.synchronize()
        _spin["ms_per_million_cycles"] = a.elapsed_time(b)
        _spin["cycles"] = int(1e6 * SPIN_MS / a.elapsed_time(b))
    return _spin["cycles"]


def cuda_ms(fn, reps=10):
    """Median of ``reps`` CUDA-event timings of fn(), after one warm-up.
    Each timed call is queued behind a spin of about SPIN_MS on the device,
    so the two events bracket the device's work and not the host's time to
    enqueue it (a wrapper's checks, allocation and launch take about 0.1 ms,
    more than some of the kernels)."""
    cycles = spin_cycles()
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def planned_config(cfg, means, covs, samples):
    plan = native.plan_capacities(cfg, means, covs, samples)
    return native.config_from_plan(cfg, plan, means.shape[0]), plan


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device visible "
                         "(torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi)
    return smi


def phase_build():
    t0 = time.perf_counter()
    _build.load()
    t_kern = time.perf_counter() - t0
    t0 = time.perf_counter()
    native._load()
    t_plan = time.perf_counter() - t0
    log = _build.build_log()
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
    spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", log)]
    stack = [int(x) for x in re.findall(r"(\d+) bytes stack frame", log)]
    by_kernel = {name: 0 for name in KERNELS}
    for entry, used in re.findall(
            r"Compiling entry function '(\S+)'[\s\S]*?Used (\d+) registers",
            log):
        names = [name for name in KERNELS if name in entry]
        if names:   # the longest: tiled_forward_sep is not tiled_forward
            name = max(names, key=len)
            by_kernel[name] = max(by_kernel[name], int(used))
    spilling = {re.sub(r"^_ZN\S*?\d+(?=[a-z_]+_kernelI)", "", entry)[:60]:
                int(b) for entry, b in re.findall(
                    r"Compiling entry function '(\S+)'[\s\S]*?"
                    r"(\d+) bytes spill stores", log) if int(b)}
    build = dict(
        kernels_s=round(t_kern, 3), planner_s=round(t_plan, 3),
        n_kernels=len(regs), max_registers=max(regs, default=0),
        max_registers_by_kernel=by_kernel, spill_store_bytes=sum(spills),
        spilling_kernels=spilling, max_stack_frame=max(stack, default=0))
    emit("build", **build)
    return build


def small_field(dev, seed, D, sigma, C, holes=False, P_small=5000,
                N_small=50000):
    """small_case's seeded field and samples: ((means, values, covs,
    conics), samples, generator)."""
    P, N = (P_small if sigma < 0.5 else 200), N_small
    g = torch.Generator(device=dev).manual_seed(seed)
    field = init_field(g, P, D, C, sigma=sigma)
    samples = 2.0 * torch.rand((N, D), generator=g, device=dev) - 1.0
    with torch.no_grad():
        if holes:
            samples[:, 0] = -samples[:, 0].abs()
            field.means[:, -1] = -field.means[:, -1].abs()
        means, values = field.means.detach(), field.values.detach()
        covs, conics = field.covariances(), field.conics()
    return (means, values, covs, conics), samples, g


def small_case(dev, seed, D, unwrapped, sigma, C, holes=False, P_small=5000,
               N_small=50000):
    """A seeded small field binned at tile 0.1275 (16 tiles per axis, so
    blocks straddle two tiles at D = 1 and tens at D = 3; every block's
    range starts at an arbitrary offset): (cfg, state, geom, smp, period, P,
    N, generator).  ``holes`` keeps the samples in the half x < 0 and the
    means in the half y < 0 (D = 2): tiles with entries and no samples,
    tiles with samples and no entries, tiles with neither."""
    (means, values, covs, conics), samples, g = small_field(
        dev, seed, D, sigma, C, holes, P_small, N_small)
    P, N = means.shape[0], samples.shape[0]
    cfg, plan = planned_config(
        SamplerConfig(tile_size=0.1275, eig_floor=1e-12).with_dims(D),
        means, covs, samples)
    if unwrapped and not plan["safe_unwrapped"]:
        raise AssertionError(f"D={D}: planner does not certify the "
                             "unwrapped kernels for this case")
    cfg = dataclasses.replace(cfg, unwrapped_kernels=unwrapped)
    state = binning.build(cfg, means, covs, samples)
    assert int(state.overflow) == 0 and int(state.entry_overflow) == 0
    geom, smp, _, _ = operands(state, (means, values, conics), samples, cfg)
    return (cfg, state, geom, smp, None if unwrapped else cfg.period, P, N,
            g)


def tile_facts(state):
    """Facts of a binning that say which corners of the sweep a case
    reaches: tiles with entries and no samples, with samples and no entries,
    and the most tiles one forward / backward block's rows lie on."""
    T = state.ent_start.shape[0] - 2
    ent = torch.diff(state.ent_start)[:T] > 0
    smp = torch.diff(state.s_start)[:T] > 0

    def most(tiles, block):
        t = tiles[tiles < T]
        t = t[:t.shape[0] // block * block].reshape(-1, block)
        return int((t[:, -1] - t[:, 0]).max()) + 1 if t.numel() else 0

    return {"tiles": T, "tiles_entries_only": int((ent & ~smp).sum()),
            "tiles_samples_only": int((smp & ~ent).sum()),
            "tiles_empty": int((~ent & ~smp).sum()),
            "most_tiles_per_fwd_block": most(state.s_tile[0], ktiled.BLOCK_N),
            "most_tiles_per_bwd_block": most(state.ent_tile[0],
                                             ktiled.BLOCK_E)}


def check_dead_rows(what, got, dead):
    """Rows that pair with nothing must come back exactly zero."""
    if bool((got[:, dead] != 0).any()):
        raise AssertionError(f"{what}: a sentinel or pad column is not 0")
    return int(dead.sum())


def dead_entries(geom, state):
    """Pad entries (tile -1.0) and culled entries (the tile count T)."""
    return (geom[0] < 0) | (geom[0] >= state.ent_start.shape[0] - 2)


def phase_parity(dev):
    cases = [(D, unwrapped, 0.03, 4, False)
             for D in (1, 2, 3) for unwrapped in (False, True)]
    cases.append((2, False, 0.6, 4, False))   # full-cover footprints, wrapped
    # The narrow channel passes, two passes (C = 6), and tiles without
    # samples or without entries.
    cases += [(D, unwrapped, 0.03, C, False) for D in (1, 2)
              for unwrapped in (False, True) for C in (1, 2, 6)]
    cases += [(3, True, 0.03, 6, False), (2, True, 0.03, 3, True),
              (2, False, 0.03, 1, True)]
    for D, unwrapped, sigma, C, holes in cases:
        _, state, geom, smp, period, P, N, _ = small_case(
            dev, 10 + D, D, unwrapped, sigma, C, holes)
        lo, n = ktiled.entry_ranges(state, smp.shape[1])
        got = ktiled.tiled_forward(ORDERS, period, D, C, geom, smp, lo, n)
        ref = ktiled.tiled_forward_plain(ORDERS, period, D, C, geom, smp,
                                         lo, n)
        torch.cuda.synchronize()
        errs = compare(got, ref, ORDERS, D, C)
        pads = check_dead_rows("forward", got, smp[D] < 0)
        emit("parity", D=D, unwrapped=unwrapped, sigma=sigma, C=C, P=P, N=N,
             holes=holes, entries=int((~dead_entries(geom, state)).sum()),
             pad_columns_zero=pads,
             ranges_off_16_bytes=int((lo[n > 0] % 4 != 0).sum()),
             **tile_facts(state), err=err_fields(errs))

    # The facade on the card against the dense masked oracle (an independent
    # reference: no binning ranges, no plain-kernel code).
    for D in (1, 2, 3):
        g = torch.Generator(device=dev).manual_seed(20 + D)
        field = init_field(g, 300, D, 3, sigma=0.05)
        samples = 2.0 * torch.rand((2000, D), generator=g, device=dev) - 1.0
        with torch.no_grad():
            m, v = field.means.detach(), field.values.detach()
            cov, con = field.covariances(), field.conics()
        cfg, _ = planned_config(SamplerConfig(tile_size=0.25).with_dims(D),
                                m, cov, samples)
        s = GaussianSampler(debug=True, config=cfg)
        s.preprocess(m, v, cov, con, samples)
        outs = s.sample_all(ORDERS)
        mask = binning.pair_mask_dense(cfg, s.state, samples, 300)
        err = {}
        for order in ORDERS:
            ref = oracle.evaluate(order, m, v, con, samples, period=cfg.period,
                                  pair_mask=mask)
            scale = max(1.0, float(ref.abs().max()))
            diff = (outs[order] - ref).abs()
            if bool((diff > ATOL_REL * scale + RTOL * ref.abs()).any()):
                raise AssertionError(f"facade vs oracle D={D} {order}: max "
                                     f"abs err {float(diff.max())}")
            err[order] = float(diff.max())
        emit("parity_oracle", D=D, P=300, N=2000, max_abs_err=err)


def phase_parity_bwd(dev):
    cases = [(D, unwrapped, 0.03, C, ORDERS, False)
             for D in (1, 2, 3) for unwrapped in (False, True)
             for C in (1, 4, 6)]
    cases.append((2, False, 0.6, 4, ORDERS, False))     # full-cover, wrapped
    cases.append((3, False, 0.03, 3, ("laplacian", "value", "third"), False))
    # The two-channel pass, the instantiations the trainers launch, and tiles
    # without samples or without entries.
    cases += [(D, unwrapped, 0.03, 2, ORDERS, False) for D in (1, 2)
              for unwrapped in (False, True)]
    cases += [(2, True, 0.03, 4, SLICE_ORDERS, False),
              (2, False, 0.03, 1, ("value", "laplacian"), False),
              (2, False, 0.03, 1, ("value",), True),
              (2, True, 0.03, 2, ("value",), True),
              (2, True, 0.03, 6, ORDERS, True)]
    for D, unwrapped, sigma, C, orders, holes in cases:
        _, state, geom, smp, period, P, N, g = small_case(
            dev, 30 + D, D, unwrapped, sigma, C, holes)
        s_lo, s_n = ktiled.sample_ranges(state, geom.shape[1])
        K = ktiled.total_unique(orders, D)
        ct = torch.randn((K * C, smp.shape[1]), generator=g, device=dev)
        got = ktiled.tiled_backward(orders, period, D, C, geom, smp, ct,
                                    s_lo, s_n)
        ref = ktiled.tiled_backward_plain(orders, period, D, C, geom, smp,
                                          ct, s_lo, s_n)
        torch.cuda.synchronize()
        errs = compare_rows(got, ref, D, C)
        dead = check_dead_rows("backward", got, dead_entries(geom, state))
        emit("parity_bwd", D=D, unwrapped=unwrapped, sigma=sigma, C=C,
             orders=list(orders), P=P, N=N, holes=holes,
             entries=int((~dead_entries(geom, state)).sum()),
             sentinel_columns_zero=dead,
             ranges_off_16_bytes=int((s_lo[s_n > 0] % 4 != 0).sum()),
             **tile_facts(state), err=err_fields(errs))

    # The op's gradients on the card against autograd through the dense
    # masked oracle, all four orders through the mirrored public outputs;
    # two runs must agree bitwise (the segment-sum and the mirror's
    # backward are deterministic).
    for D in (1, 2, 3):
        g = torch.Generator(device=dev).manual_seed(40 + D)
        field = init_field(g, 300, D, 3, sigma=0.05)
        samples = 2.0 * torch.rand((2000, D), generator=g, device=dev) - 1.0
        with torch.no_grad():
            m, v = field.means.detach(), field.values.detach()
            cov, con = field.covariances(), field.conics()
        cfg, _ = planned_config(SamplerConfig(tile_size=0.25).with_dims(D),
                                m, cov, samples)
        state = binning.build(cfg, m, cov, samples)
        mask = binning.pair_mask_dense(cfg, state, samples, 300)

        def grads(loss):
            args = [a.clone().requires_grad_() for a in (m, v, con)]
            return torch.autograd.grad(loss(*args), args)

        def loss_tiled(m_, v_, c_):
            outs = sampling.sample_tiled_multi(
                ORDERS, cfg, m_, v_, c_, samples, state,
                unwrapped=cfg.unwrapped_kernels)
            return sum((o ** 2).sum() for o in outs)

        def loss_oracle(m_, v_, c_):
            return sum((oracle.evaluate(o, m_, v_, c_, samples,
                                        period=cfg.period,
                                        pair_mask=mask) ** 2).sum()
                       for o in ORDERS)

        got, again = grads(loss_tiled), grads(loss_tiled)
        ref = grads(loss_oracle)
        err = {}
        for name, a, b, r in zip(("means", "values", "conics"), got, again,
                                 ref):
            if not torch.equal(a, b):
                raise AssertionError(f"D={D} d{name}: two runs differ")
            scale = max(1.0, float(r.abs().max()))
            diff = (a - r).abs()
            if bool((diff > ATOL_REL * scale + GRAD_RTOL * r.abs()).any()):
                raise AssertionError(f"op grads vs oracle D={D} d{name}: "
                                     f"max abs err {float(diff.max())}")
            err[name] = float(diff.max())
        emit("parity_bwd_oracle", D=D, P=300, N=2000, max_abs_err=err,
             bitwise_repeatable=True)


def headline(dev, P, N, C=4, seed=0):
    """The headline field and samples (D = 2, sigma = 2 / sqrt(P)) and
    its planned config."""
    D = 2
    g = torch.Generator(device=dev).manual_seed(seed)
    field = init_field(g, P, D, C, sigma=2.0 / math.sqrt(P))
    samples = 2.0 * torch.rand((N, D), generator=g, device=dev) - 1.0
    with torch.no_grad():
        means, values = field.means.detach(), field.values.detach()
        covs, conics = field.covariances(), field.conics()
    t0 = time.perf_counter()
    cfg, _ = planned_config(SamplerConfig(**HEADLINE), means, covs, samples)
    return (means, values, covs, conics), samples, cfg, \
        time.perf_counter() - t0


def pair_counts(state):
    """(kept pairs, real entries) of a binning: per tile, entries times
    samples."""
    T = state.ent_start.shape[0] - 2
    ent_count = torch.diff(state.ent_start)[:T].long()
    smp_count = torch.diff(state.s_start)[:T].long()
    return int((ent_count * smp_count).sum()), int(ent_count.sum())


def swept_pairs(state, side):
    """Lane slots the kernel's sweep spends on these operands: each warp
    (32 consecutive sorted rows) walks its whole range with all its lanes,
    so a warp that straddles tiles pays for every tile under it."""
    if side == "forward":
        _, n = binning.forward_geometry(state, ktiled.BLOCK_N, 1)
        return int(n.long().sum()) * ktiled.BLOCK_N
    _, n = binning.backward_geometry(state, ktiled.BLOCK_E, 1)
    return int(n.long().sum()) * ktiled.BLOCK_E


def instantiation(kernel, orders, D, C, period):
    """{"registers", "shared_bytes", "pass", "wrap"} of the instantiation of
    ``kernel`` ("tiled_forward" / "tiled_backward") that (orders, D, C,
    period) launches, from the ptxas report of the build."""
    lib = _build.load()
    mask = ktiled._order_rows(orders, D)[0]
    cb = getattr(lib, f"dgs_{kernel}_pass")(D, C)
    wrapped = int(period is not None)
    name = f"{kernel}_kernelILi{D}ELi{mask}ELi{cb}ELb{wrapped}EE"
    reports = [
        r for r in _build.build_log().split("Compiling entry function")[1:]
        if name in r.split("'")[1]]
    if len(reports) != 1:
        raise AssertionError(f"{len(reports)} ptxas reports for {name}")
    regs = re.search(r"Used (\d+) registers", reports[0])
    smem = re.search(r"(\d+) bytes smem", reports[0])
    return {"registers": int(regs.group(1)),
            "shared_bytes": int(smem.group(1)) if smem else 0, "pass": cb,
            "wrap": ("scaled" if lib.dgs_tiled_wrap_scaled(period)
                     else "divide") if wrapped else "none"}


def resident_blocks(registers, threads, shared_bytes):
    """Blocks of a kernel an H100 SM holds at once, from its registers a
    thread and static shared bytes a block (the ptxas report): registers
    are allocated 256 a warp from 65,536, shared memory from 228 KB with 1
    KB reserved a block; at most 32 blocks and 64 warps an SM."""
    warps = threads // 32
    by_regs = 65536 // (-(-registers * 32 // 256) * 256 * warps)
    by_smem = 228 * 1024 // (shared_bytes + 1024)
    return min(by_regs, by_smem, 32, 64 // warps)


def dense_instantiation(kernel, orders, D, C, period):
    """{"registers", "shared_bytes", "resident_blocks"} of the instantiation
    of ``kernel`` ("dense_forward" / "dense_backward") that (orders, D, C,
    period) launches, from the ptxas report of the build.  A tree whose
    dense kernels take no pass or wrap template value (the first design) has
    one instantiation per (D, orders)."""
    mask = kdense._canonical(orders, D)[0]
    reports = [
        r for r in _build.build_log().split("Compiling entry function")[1:]
        if f"{kernel}_kernelILi{D}ELi{mask}E" in r.split("'")[1]]
    if len(reports) > 1:
        tag = (f"ELi{_build.load().dgs_dense_pass(D, C)}"
               f"ELb{int(period is not None)}EE")
        reports = [r for r in reports if tag in r.split("'")[1]]
    if len(reports) != 1:
        raise AssertionError(f"{len(reports)} ptxas reports for {kernel} "
                             f"D={D} mask={mask}")
    regs = int(re.search(r"Used (\d+) registers", reports[0]).group(1))
    smem = re.search(r"(\d+) bytes smem", reports[0])
    smem = int(smem.group(1)) if smem else 0
    return {"registers": regs, "shared_bytes": smem,
            "resident_blocks": resident_blocks(regs, 128, smem)}


def dense_blocks(kernel, P, N):
    """The blocks of a dense kernel's launch at P Gaussians x N samples
    (its split plan's)."""
    if kernel == "dense_forward":
        n_blocks = -(-N // kdense.BLOCK_N)
        splits = kdense.split_plan(n_blocks, P, kdense.FWD_CHUNK)[0]
    else:
        n_blocks = -(-P // kdense.BLOCK_P)
        splits = kdense.split_plan(n_blocks, N, kdense.BWD_CHUNK)[0]
    return n_blocks * splits


def segment_numbers(rows, gid, P, slots):
    """The segment-sum on per-entry rows ``rows`` (F, E), as the backward
    kernels hand them (the transpose view of an entry-major (E, F) buffer),
    and their Gaussian ids ``gid``.  The kernel in both layouts it reads,
    that view and contiguous feature-major rows, each bitwise equal to the
    plain version (all add each run in run order), with its time; the plain
    version's time; index_add_ (the PyTorch call that computes the same
    sums, in no fixed order) on each layout, the entry-major one as
    library_ms; segment_sum_rows as a whole (the sort by gid, searchsorted,
    the slot check and the kernel) with its launches, and the sort and
    searchsorted alone; the byte bound (rows and ids read once, the (P, F)
    sums written once)."""
    F, E = rows.shape
    layouts = {"entry_major": (rows if rows.stride() == (1, F)
                               else rows.T.contiguous().T),
               "feature_major": rows.contiguous()}

    def sort():
        g_sorted, order = torch.sort(gid, stable=True)
        return order, torch.searchsorted(
            g_sorted, torch.arange(P + 1, dtype=g_sorted.dtype,
                                   device=gid.device), out_int32=True)

    order, starts = sort()
    ref = segment.segment_sum_plain(layouts["feature_major"], order, starts)
    idx = gid.long()
    ms, library_ms, library_err = {}, {}, 0.0
    for name, r in layouts.items():
        got = segment.segment_sum(r, order, starts)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"segment_sum kernel ({name} rows) and "
                                 "plain version differ")
        ms[name] = cuda_ms(lambda: segment.segment_sum(r, order, starts))
        acc = rows.new_zeros((P + 1, F))
        lib = acc.clone().index_add_(0, idx, r.T)[:P]
        library_err = max(library_err, check_close(
            "index_add_ against the segment-sum kernel", lib, got, RTOL)[0])
        library_ms[name] = cuda_ms(lambda: acc.index_add_(0, idx, r.T))
    plain_ms = cuda_ms(lambda: segment.segment_sum_plain(
        layouts["entry_major"], order, starts), reps=3)
    view = layouts["entry_major"]
    before = segment.segment_sum.launches
    whole = sampling.segment_sum_rows(view, gid, P, slots)
    launches = segment.segment_sum.launches - before
    torch.cuda.synchronize()
    if launches != 1 or not torch.equal(whole, ref):
        raise AssertionError(f"segment_sum_rows: {launches} launches, "
                             f"equal to plain {torch.equal(whole, ref)}")
    bound = 1e3 * 4 * (F * E + E + P * F) / MEM_BYTES_S
    return {"max_abs_err": 0.0, "ms": ms["entry_major"], "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "bytes",
            "library_ms": library_ms["entry_major"],
            "library_max_abs_err": library_err,
            "bitwise_equal_to_plain": True, "ms_by_layout": ms,
            "library_ms_by_layout": library_ms,
            "segment_sum_rows_ms": cuda_ms(
                lambda: sampling.segment_sum_rows(view, gid, P, slots)),
            "segment_sum_rows_launches": launches, "sort_ms": cuda_ms(sort),
            "entries": E, "rows": F, "gaussians": P}


def segment_memory(dev, P=100_000, D=3, R=8, C=4):
    """Peak device memory of ops.sampling.segment_sum_rows at D = 3, R = 8
    and P = 100,000 (slots R^D = 512 a Gaussian) beyond its operands: each
    Gaussian a seeded count of 1 to 64 entries, 4,096 sentinel entries,
    the entries shuffled, F = D + tri + C = 13 rows, entry-major as the
    backward kernels write them.  ``slot_layout_bytes`` is the size of the
    (P * R^D + 1, F) slot buffer that the earlier segment-sum allocated
    (computed, not measured)."""
    g = torch.Generator(device=dev).manual_seed(5)
    counts = torch.randint(1, 65, (P,), generator=g, device=dev)
    gid = torch.cat([torch.repeat_interleave(
        torch.arange(P, device=dev), counts),
        torch.full((4096,), P, device=dev)])
    gid = gid[torch.randperm(gid.shape[0], generator=g, device=dev)].to(
        torch.int32)
    F, E = D + D * (D + 1) // 2 + C, gid.shape[0]
    rows = torch.randn((E, F), generator=g, device=dev).T
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = sampling.segment_sum_rows(rows, gid, P, R ** D)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    fields = dict(P=P, D=D, R=R, slots=R ** D, rows=F, entries=E,
                  peak_bytes=peak, operand_bytes=4 * (F * E + E),
                  output_bytes=4 * P * F,
                  slot_layout_bytes=4 * (P * R ** D + 1) * F,
                  finite=bool(torch.isfinite(out).all()))
    emit("segment_memory", **fields)
    return fields, rows, gid


def segment_d3_rows(dev, P=100_000, N=1_000_000):
    """The per-entry rows of a real D = 3 binning and their Gaussian ids:
    the tiled backward's (all four orders, C = 4, unwrapped, tile 0.1275)
    at 100,000 x 1,000,000 on a random cotangent, the shape of
    tiled_times' d3_wide case; (rows, gid, P, slots)."""
    cfg, state, geom, smp, period, P, _, g = small_case(
        dev, 13, 3, True, 0.03, 4, P_small=P, N_small=N)
    s_lo, s_n = ktiled.sample_ranges(state, geom.shape[1])
    ct = torch.randn((ktiled.total_unique(ORDERS, 3) * 4, smp.shape[1]),
                     generator=g, device=dev)
    rows = ktiled.tiled_backward(ORDERS, period, 3, 4, geom, smp, ct, s_lo,
                                 s_n)
    E = state.num_entries
    gid = torch.full((geom.shape[1],), P, dtype=state.ent_gid.dtype,
                     device=dev)
    gid[:E] = state.ent_gid[:E]
    return rows, gid, P, cfg.max_tiles_per_gaussian ** 3


def phase_segment(dev):
    """The segment-sum at D = 3, R = 8, P = 100,000 (segment_memory): its
    peak memory must stay within the operands and output, O(E F), with no
    P * R^D slot buffer; and the kernel against its plain version there,
    and on the rows of a real D = 3 binning (segment_d3_rows)."""
    fields, rows, gid = segment_memory(dev)
    if fields["peak_bytes"] > fields["operand_bytes"] + fields["output_bytes"]:
        raise AssertionError(f"segment_sum_rows peak {fields['peak_bytes']} "
                             "bytes exceeds its operands and output")
    numbers = segment_numbers(rows, gid, fields["P"], fields["slots"])
    emit("segment", case="d3_r8", **numbers)
    real = segment_numbers(*segment_d3_rows(dev))
    emit("segment", case="d3_real", **real)
    return ({**numbers, "peak_bytes": fields["peak_bytes"]}, real)


def phase_slice(dev, P=100_000, N=1_000_000):
    D, C = 2, 4
    (means, values, covs, conics), samples, cfg, plan_s = headline(
        dev, P, N, C)
    sampler = GaussianSampler(config=cfg)

    def run():
        sampler.preprocess(means, values, covs, conics, samples)
        return sampler.sample_all(SLICE_ORDERS)

    run()                               # warm-up (allocator, planner caches)
    torch.cuda.synchronize()
    reset_launches()
    e2e = []
    for _ in range(5):
        t0 = time.perf_counter()
        outs = run()
        torch.cuda.synchronize()
        e2e.append((time.perf_counter() - t0) * 1e3)
    # Evaluation takes no gradient: five forward launches, no backward;
    # each preprocess bins the Gaussians once.
    launches = expect_launches("5 evaluations", tiled_forward=5,
                               binning_keys=5)

    state = sampler.state
    _, diag = sampling.sample_binned(cfg, means, values, conics, covs,
                                     samples, SLICE_ORDERS)
    diag = {k: int(v) for k, v in diag.items() if k != "perm"}
    if any(diag.values()):
        raise AssertionError(f"overflow diagnostics not zero: {diag}")
    shapes = {o: list(outs[o].shape) for o in SLICE_ORDERS}
    want = {"value": [N, C], "derivative": [N, D, C],
            "laplacian": [N, D, D, C]}
    if shapes != want:
        raise AssertionError(f"output shapes {shapes}, expected {want}")
    for o in SLICE_ORDERS:
        if not bool(torch.isfinite(outs[o]).all()):
            raise AssertionError(f"non-finite {o} output")

    pairs, entries = pair_counts(state)

    period = None if cfg.unwrapped_kernels else cfg.period
    geom, smp, lo, n = operands(state, (means, values, conics), samples, cfg)
    swept = swept_pairs(state, "forward")
    got = ktiled.tiled_forward(SLICE_ORDERS, period, D, C, geom, smp, lo, n)
    ref = ktiled.tiled_forward_plain(SLICE_ORDERS, period, D, C, geom, smp,
                                     lo, n)
    torch.cuda.synchronize()
    errs = compare(got, ref, SLICE_ORDERS, D, C)
    kernel_ms = cuda_ms(lambda: ktiled.tiled_forward(
        SLICE_ORDERS, period, D, C, geom, smp, lo, n))
    plain_ms = cuda_ms(lambda: ktiled.tiled_forward_plain(
        SLICE_ORDERS, period, D, C, geom, smp, lo, n))
    emit("slice", P=P, N=N, D=D, C=C, tile=cfg.tile_size,
         unwrapped_kernels=cfg.unwrapped_kernels,
         max_tiles_per_gaussian=cfg.max_tiles_per_gaussian,
         entries=entries, pairs=pairs, swept_pairs_bound=swept,
         diagnostics=diag, launches=launches, output_shapes=shapes,
         compared_samples=N, err=err_fields(errs),
         kernel_ms=kernel_ms, plain_ms=plain_ms,
         e2e_ms_median=statistics.median(e2e), e2e_ms=e2e,
         planner_s=round(plan_s, 3))
    moved = sum(t.numel() for t in (geom, smp, lo, n, got))
    return launches, {
        "max_abs_err": max(e[0] for e in errs.values()),
        "ms": kernel_ms, "plain_ms": plain_ms,
        **kernel_bound(pairs, moved, D, SLICE_ORDERS, C,
                       period is not None, False),
        "kept_pairs": pairs, "swept_pairs": swept,
        **instantiation("tiled_forward", SLICE_ORDERS, D, C, period)}


def headline_step(dev, P, N, C=4):
    """The headline training step as a closure, with what it was built
    from: (step, params, (means, values, covs, conics), samples, cfg, sample
    binning, multiplicities, planner seconds)."""
    D = 2
    (means, values, covs, conics), samples, cfg, plan_s = headline(
        dev, P, N, C)
    sb = binning.bin_samples(cfg, samples)   # the samples are fixed
    mult = {o: torch.tensor(formulas.sym_multiplicity(o, D),
                            dtype=torch.float32, device=dev)
            for o in SLICE_ORDERS}
    params = [t.clone().requires_grad_() for t in (means, values, conics)]

    def step():
        """One training step of the bench's loss (bench.py:195-214): the
        Gaussians re-binned, the fused forward, backward()."""
        for p in params:
            p.grad = None
        outs, diag = sampling.sample_binned(
            cfg, params[0], params[1], params[2], covs, samples,
            SLICE_ORDERS, sorted_outputs=True, unique_outputs=True,
            padded_outputs=True, sample_binning=sb)
        loss = sum(torch.einsum("ucn,u->", o * o, mult[k])
                   for k, o in outs.items()) / N
        loss.backward()
        return loss.detach(), diag

    return (step, params, (means, values, covs, conics), samples, cfg, sb,
            mult, plan_s)


def phase_train_step(dev, P=100_000, N=1_000_000):
    D, C = 2, 4
    (step, params, (means, values, covs, conics), samples, cfg, sb, mult,
     plan_s) = headline_step(dev, P, N, C)

    loss, diag = step()                      # warm-up
    torch.cuda.synchronize()
    reset_launches()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        loss, diag = step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = expect_launches("5 training steps", tiled_forward=5,
                               tiled_backward=5, segment_sum=5,
                               binning_keys=5)
    diag = {k: int(v) for k, v in diag.items() if k != "perm"}
    if any(diag.values()):
        raise AssertionError(f"overflow diagnostics not zero: {diag}")
    grads = [p.grad.clone() for p in params]
    for name, gr, p in zip(("means", "values", "conics"), grads, params):
        if gr.shape != p.shape or not bool(torch.isfinite(gr).all()):
            raise AssertionError(f"d{name}: non-finite or misshapen")
    step()
    torch.cuda.synchronize()
    repeat = [bool(torch.equal(a, p.grad)) for a, p in zip(grads, params)]
    if not all(repeat):
        raise AssertionError(f"gradients differ between two runs: {repeat}")

    # The backward kernel against its plain version on this step's own
    # operands and cotangent (d loss / d packed outputs).
    state = binning.build(cfg, means, covs, samples, sample_binning=sb)
    pairs, entries = pair_counts(state)
    geom, smp, lo, n = operands(state, (means, values, conics), samples, cfg)
    period = None if cfg.unwrapped_kernels else cfg.period
    with torch.no_grad():
        packed = ktiled.tiled_forward(SLICE_ORDERS, period, D, C, geom, smp,
                                      lo, n)
        w = torch.cat([mult[o].repeat_interleave(C) for o in SLICE_ORDERS])
        ct = (2.0 / N) * w[:, None] * packed
    s_lo, s_n = ktiled.sample_ranges(state, geom.shape[1])
    swept = swept_pairs(state, "backward")
    got = ktiled.tiled_backward(SLICE_ORDERS, period, D, C, geom, smp, ct,
                                s_lo, s_n)
    ref = ktiled.tiled_backward_plain(SLICE_ORDERS, period, D, C, geom, smp,
                                      ct, s_lo, s_n)
    torch.cuda.synchronize()
    errs = compare_rows(got, ref, D, C)
    bwd_ms = cuda_ms(lambda: ktiled.tiled_backward(
        SLICE_ORDERS, period, D, C, geom, smp, ct, s_lo, s_n))
    bwd_plain_ms = cuda_ms(lambda: ktiled.tiled_backward_plain(
        SLICE_ORDERS, period, D, C, geom, smp, ct, s_lo, s_n), reps=3)
    gid = ktiled.prepare_entries(state, means, values, conics, ktiled.BLOCK_E,
                                 cfg=cfg)[0]
    seg = segment_numbers(got, gid, P, cfg.max_tiles_per_gaussian ** D)
    emit("train_step", P=P, N=N, D=D, C=C, tile=cfg.tile_size,
         unwrapped_kernels=cfg.unwrapped_kernels,
         max_tiles_per_gaussian=cfg.max_tiles_per_gaussian,
         entries=entries, pairs=pairs, swept_pairs_bound=swept,
         diagnostics=diag, launches=launches, loss=float(loss),
         grads_bitwise_repeatable=True, err=err_fields(errs),
         bwd_kernel_ms=bwd_ms, bwd_plain_ms=bwd_plain_ms,
         segment_sum=seg,
         step_ms_median=statistics.median(times), step_ms=times,
         planner_s=round(plan_s, 3))
    moved = sum(t.numel() for t in (geom, smp, ct, s_lo, s_n, got))
    return launches, {
        "max_abs_err": max(e[0] for e in errs.values()),
        "ms": bwd_ms, "plain_ms": bwd_plain_ms,
        **kernel_bound(pairs, moved, D, SLICE_ORDERS, C,
                       period is not None, True),
        "kept_pairs": pairs, "swept_pairs": swept,
        **instantiation("tiled_backward", SLICE_ORDERS, D, C, period)}, \
        seg, step


PIGS_CFG = dict(tile_size=0.051, eig_floor=1e-12, axis_radii=True,
                ellip_cull=True)
PIGS_P, PIGS_COLLOCATION, PIGS_LR = 100_000, 262_144, 2e-3


def phase_pigs(dev, P=PIGS_P, steps=120, n_collocation=PIGS_COLLOCATION):
    reset_launches()
    t0 = time.perf_counter()
    state, history = pigs.train(
        SamplerConfig(**PIGS_CFG), P=P, D=2, C=1, steps=steps,
        n_collocation=n_collocation, learning_rate=PIGS_LR,
        sigma=2.0 / math.sqrt(P), log_every=max(steps // 6, 1), device=dev)
    wall = time.perf_counter() - t0
    # Each step bins and evaluates the collocation and the data points:
    # two launches of each kernel.
    launches = expect_launches(f"{steps} PIGS steps",
                               tiled_forward=2 * steps,
                               tiled_backward=2 * steps,
                               segment_sum=2 * steps,
                               binning_keys=2 * steps)
    for h in history:
        over = {k: h[k] for k in pigs.DIAGNOSTICS if h[k]}
        if over:
            raise AssertionError(f"overflow at step {h['step']}: {over}")
    first, last = history[0]["loss"], history[-1]["loss"]
    if not (math.isfinite(last) and last < 0.5 * first):
        raise AssertionError(f"PIGS loss did not halve: {first} -> {last}")
    warm = [h["t_step_s"] for h in history[1:]]
    emit("pigs", P=P, D=2, C=1, steps=steps, n_collocation=n_collocation,
         t_step_s_warm=min(warm), t_step_s=[h["t_step_s"] for h in history],
         wall_s=round(wall, 3), loss_first=first, loss_last=last,
         loss_curve=[h["loss"] for h in history],
         loss_steps=[h["step"] for h in history], launches=launches)
    return launches


def dense_operands(dev, seed, P, N, D, C, sigma):
    """((means, values, conics, samples), covariances, generator): a
    seeded field's parameters and uniform samples on the card, detached."""
    g = torch.Generator(device=dev).manual_seed(seed)
    field = init_field(g, P, D, C, sigma=sigma)
    samples = 2.0 * torch.rand((N, D), generator=g, device=dev) - 1.0
    with torch.no_grad():
        return (field.means.detach(), field.values.detach(),
                field.conics(), samples), field.covariances(), g


def compare_components(got, ref, orders, D):
    """Per-order errors of the dense forward's K per-component (N, C)
    tensors against the plain version's."""
    errs, k0 = {}, 0
    for order in orders:
        k = D ** ORDERS.index(order)
        errs[order] = check_close(
            f"dense forward kernel against the plain version on {order}",
            torch.stack(got[k0:k0 + k]), torch.stack(ref[k0:k0 + k]), RTOL)
        k0 += k
    return errs


def compare_groups(got, ref):
    """Per-group errors of the dense backward's (dmeans, dvalues, dconics)
    against the plain version's."""
    return {name: check_close(
        f"dense backward kernel against the plain version on {name}", g, r,
        GRAD_RTOL) for name, g, r in zip(("means", "values", "conics"),
                                         got, ref)}


def dense_cases():
    """(D, period, C, orders, P, N, sigma) of the dense parity phases."""
    cases = [(D, period, C, ORDERS, 2000, 20000, 0.1)
             for D in (1, 2, 3) for period in (2.0, None) for C in (1, 4, 6)]
    cases.append((3, 2.0, 3, ("laplacian",), 2000, 20000, 0.1))
    cases.append((3, 2.0, 3, ("laplacian", "value", "third"), 2000, 20000,
                  0.1))
    # A period that is no power of two (the dividing wrap), the two-channel
    # pass, and the PIGS trainer's order sets at C = 1.
    cases += [(D, 1.5, C, ORDERS, 2000, 20000, 0.1)
              for D in (1, 2, 3) for C in (2, 4)]
    cases += [(2, 2.0, 2, ORDERS, 2000, 20000, 0.1),
              (2, 2.0, 1, ("value", "laplacian"), 2000, 20000, 0.1),
              (2, 2.0, 1, ("value",), 2000, 20000, 0.1)]
    # Sizes that are no multiple of a block or a chunk.
    cases += [(2, 2.0, 2, ORDERS, P, N, 0.3)
              for P, N in ((1, 1), (5, 3), (130, 129), (257, 300))]
    return cases


def phase_parity_dense(dev):
    for D, period, C, orders, P, N, sigma in dense_cases():
        args, _, _ = dense_operands(dev, 50 + D, P, N, D, C, sigma)
        got = kdense.dense_forward(orders, period, *args)
        ref = kdense.dense_forward_plain(orders, period, *args)
        torch.cuda.synchronize()
        if len(got) != kdense.total_components(orders, D):
            raise AssertionError(f"{len(got)} components for {orders}")
        errs = compare_components(got, ref, orders, D)
        emit("parity_dense", D=D, period=period, C=C, orders=list(orders),
             P=P, N=N, err=err_fields(errs))


def phase_parity_dense_bwd(dev):
    for D, period, C, orders, P, N, sigma in dense_cases():
        args, _, g = dense_operands(dev, 60 + D, P, N, D, C, sigma)
        gs = list(torch.randn((kdense.total_components(orders, D), N, C),
                              generator=g, device=dev))
        got = kdense.dense_backward(orders, period, *args, gs)
        ref = kdense.dense_backward_plain(orders, period, *args, gs)
        torch.cuda.synchronize()
        errs = compare_groups(got, ref)
        emit("parity_dense_bwd", D=D, period=period, C=C,
             orders=list(orders), P=P, N=N, err=err_fields(errs))

    # The op's gradients on the card against autograd through the dense
    # oracle, all four orders; two runs must agree bitwise (no atomics,
    # and the split of the sample axis depends on the shapes only).
    for D in (1, 2, 3):
        (m, v, con, samples), _, _ = dense_operands(dev, 70 + D, 300, 2000,
                                                    D, 3, 0.05)

        def grads(loss):
            args = [a.clone().requires_grad_() for a in (m, v, con)]
            return torch.autograd.grad(loss(*args), args)

        def loss_kernels(m_, v_, c_):
            outs = sampling.sample_all(m_, v_, c_, samples, method="pallas")
            return sum((o ** 2).sum() for o in outs.values())

        def loss_oracle(m_, v_, c_):
            return sum((oracle.evaluate(o, m_, v_, c_, samples) ** 2).sum()
                       for o in ORDERS)

        got, again = grads(loss_kernels), grads(loss_kernels)
        ref = grads(loss_oracle)
        err = {}
        for name, a, b, r in zip(("means", "values", "conics"), got, again,
                                 ref):
            if not torch.equal(a, b):
                raise AssertionError(f"D={D} d{name}: two runs differ")
            err[name] = check_close(f"dense op grads vs oracle D={D} "
                                    f"d{name}", a, r, GRAD_RTOL)[0]
        emit("parity_dense_bwd_oracle", D=D, P=300, N=2000, max_abs_err=err,
             bitwise_repeatable=True)


DENSE_P, DENSE_N = 10_000, 100_000


def dense_config2(dev, P=DENSE_P, N=DENSE_N):
    """Dense config 2 (D = 3, C = 4, period 2.0, all four orders) and its
    training step through GaussianSampler(method="pallas"): the sum of
    squares of all outputs, backward() to means, values and conics.
    Returns ((means, values, conics, samples), covs, period, sampler,
    params, step)."""
    D, C = 3, 4
    (means, values, conics, samples), covs, _ = dense_operands(
        dev, 0, P, N, D, C, 2.0 / P ** (1.0 / 3.0))
    period = SamplerConfig().period
    sampler = GaussianSampler(method="pallas")
    params = [t.clone().requires_grad_() for t in (means, values, conics)]

    def step():
        for p in params:
            p.grad = None
        sampler.preprocess(params[0], params[1], covs, params[2], samples)
        loss = sum((o * o).sum() for o in sampler.sample_all(ORDERS).values())
        loss.backward()
        return loss.detach()

    return (means, values, conics, samples), covs, period, sampler, params, \
        step


def phase_dense_slice(dev, P=DENSE_P, N=DENSE_N):
    D, C = 3, 4
    ((means, values, conics, samples), covs, period, sampler, params,
     step) = dense_config2(dev, P, N)

    def run():
        sampler.preprocess(means, values, covs, conics, samples)
        return sampler.sample_all(ORDERS)

    reset_launches()
    e2e = host_ms(run, 5)
    outs = run()
    torch.cuda.synchronize()
    eval_launches = expect_launches("7 dense evaluations", dense_forward=7)
    want = {"value": [N, C], "derivative": [N, D, C],
            "laplacian": [N, D, D, C], "third": [N, D, D, D, C]}
    shapes = {o: list(outs[o].shape) for o in ORDERS}
    if shapes != want:
        raise AssertionError(f"output shapes {shapes}, expected {want}")
    for o in ORDERS:
        if not bool(torch.isfinite(outs[o]).all()):
            raise AssertionError(f"non-finite {o} output")
    # The first samples against the dense oracle, which shares no code with
    # the kernels or their plain versions.
    n_ref = 512
    ref = oracle.evaluate_all(means, values, conics, samples[:n_ref],
                              period=period)
    oracle_err = {o: check_close(f"dense path vs oracle on {o}",
                                 outs[o][:n_ref], ref[o], RTOL)[0]
                  for o in ORDERS}
    del ref

    # A training step at the same width.
    reset_launches()
    step_times = host_ms(step, 5)
    step_launches = expect_launches("6 dense training steps",
                                    dense_forward=6, dense_backward=6)
    grads = [p.grad.clone() for p in params]
    for name, gr, p in zip(("means", "values", "conics"), grads, params):
        if gr.shape != p.shape or not bool(torch.isfinite(gr).all()):
            raise AssertionError(f"d{name}: non-finite or misshapen")
    loss = step()
    torch.cuda.synchronize()
    repeat = [bool(torch.equal(a, p.grad)) for a, p in zip(grads, params)]
    if not all(repeat):
        raise AssertionError(f"gradients differ between two runs: {repeat}")

    # Each kernel against its plain version: the forward on all samples,
    # the backward on the step's own cotangent (d loss / d outputs = 2 out).
    args = (means, values, conics, samples)
    got = kdense.dense_forward(ORDERS, period, *args)
    t0 = time.perf_counter()
    ref = kdense.dense_forward_plain(ORDERS, period, *args)
    torch.cuda.synchronize()
    fwd_plain_ms = (time.perf_counter() - t0) * 1e3
    fwd_errs = compare_components(got, ref, ORDERS, D)
    del ref
    gs = [2.0 * c for c in got]
    got_b = kdense.dense_backward(ORDERS, period, *args, gs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref_b = kdense.dense_backward_plain(ORDERS, period, *args, gs)
    torch.cuda.synchronize()
    bwd_plain_ms = (time.perf_counter() - t0) * 1e3
    bwd_errs = compare_groups(got_b, ref_b)
    fwd_ms = cuda_ms(lambda: kdense.dense_forward(ORDERS, period, *args))
    bwd_ms = cuda_ms(lambda: kdense.dense_backward(ORDERS, period, *args,
                                                   gs))
    K = kdense.total_components(ORDERS, D)
    operand_floats = sum(t.numel() for t in args)
    emit("dense_slice", P=P, N=N, D=D, C=C, period=period, pairs=N * P,
         components=K, output_shapes=shapes,
         launches={"evaluations": eval_launches, "steps": step_launches},
         oracle_samples=n_ref, oracle_max_abs_err=oracle_err,
         compared_samples=N, err=err_fields(fwd_errs),
         bwd_err=err_fields(bwd_errs), loss=float(loss),
         grads_bitwise_repeatable=True,
         fwd_splits=kdense.split_plan(-(-N // kdense.BLOCK_N), P,
                                      kdense.FWD_CHUNK)[0],
         bwd_splits=kdense.split_plan(-(-P // kdense.BLOCK_P), N,
                                      kdense.BWD_CHUNK)[0],
         kernel_ms=fwd_ms, plain_ms=fwd_plain_ms, bwd_kernel_ms=bwd_ms,
         bwd_plain_ms=bwd_plain_ms,
         e2e_ms_median=statistics.median(e2e), e2e_ms=e2e,
         step_ms_median=statistics.median(step_times), step_ms=step_times)
    k_fwd = {"max_abs_err": max(e[0] for e in fwd_errs.values()),
             "ms": fwd_ms, "plain_ms": fwd_plain_ms,
             **kernel_bound(N * P, operand_floats + K * N * C, D, ORDERS, C,
                            True, False),
             "blocks": dense_blocks("dense_forward", P, N),
             **dense_instantiation("dense_forward", ORDERS, D, C, period)}
    k_bwd = {"max_abs_err": max(e[0] for e in bwd_errs.values()),
             "ms": bwd_ms, "plain_ms": bwd_plain_ms,
             **kernel_bound(N * P, operand_floats + K * N * C
                            + sum(t.numel() for t in got_b), D, ORDERS, C,
                            True, True),
             "blocks": dense_blocks("dense_backward", P, N),
             **dense_instantiation("dense_backward", ORDERS, D, C, period)}
    return eval_launches, step_launches, k_fwd, k_bwd, step


def phase_pigs_dense(dev, P=10_000, steps=120, n_collocation=16_384):
    """PIGS through the all-pairs kernels, and the tiled path from the same
    seed as its control.  The two curves differ by the tiled path's
    3-sigma cut and by their collocation draws (the tiled run spends one
    draw on the capacity probe), so no closeness is asserted."""
    runs = {}
    for method in ("pallas", "tiled"):
        reset_launches()
        t0 = time.perf_counter()
        _, history = pigs.train(
            SamplerConfig(**{**PIGS_CFG, "tile_size": 0.125}), P=P, D=2,
            C=1, steps=steps, n_collocation=n_collocation,
            learning_rate=PIGS_LR, sigma=2.0 / math.sqrt(P), method=method,
            log_every=max(steps // 6, 1), device=dev)
        wall = time.perf_counter() - t0
        kernels = (("dense_forward", "dense_backward") if method == "pallas"
                   else ("tiled_forward", "tiled_backward", "segment_sum",
                         "binning_keys"))
        launches = expect_launches(f"{steps} PIGS steps ({method})",
                                   **{k: 2 * steps for k in kernels})
        for h in history:
            over = {k: h[k] for k in pigs.DIAGNOSTICS if h[k]}
            if over:
                raise AssertionError(
                    f"{method}: overflow at step {h['step']}: {over}")
        first, last = history[0]["loss"], history[-1]["loss"]
        if not (math.isfinite(last) and last < 0.5 * first):
            raise AssertionError(
                f"PIGS loss ({method}) did not halve: {first} -> {last}")
        runs[method] = dict(
            launches=launches, wall_s=round(wall, 3),
            t_step_s_warm=min(h["t_step_s"] for h in history[1:]),
            loss_curve=[h["loss"] for h in history])
    emit("pigs_dense", P=P, D=2, C=1, steps=steps,
         n_collocation=n_collocation,
         loss_steps=[h["step"] for h in history], **runs)
    return runs["pallas"]["launches"]


AGG_GROUPS = ("features", "transform", "queries", "keys", "frequencies",
              "distance_transform")


def agg_case(dev, seed, P, D, L, K, nfreq, sigma, *, period=2.0,
             ladder=False, cull=0, tile_range=None, spread=None, E=None):
    """A seeded cloud, its kernel aggregation structure and random
    parameters of the six groups: (cfg, (means, conics, radii), params,
    agg).  ``cull`` > 0 zeroes every cull-th radius; ``tile_range`` is a
    pair of fractions of the tile count; ``spread`` scales the means (a
    dense cluster below 1); ``E`` is the distance transform's half length
    (default 2 D nfreq + 1)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    field = init_field(g, P, D, L, sigma=sigma)
    if spread is not None:
        with torch.no_grad():
            field.means.mul_(spread)
    cfg = (SamplerConfig(eig_floor=1e-12) if period
           else SamplerConfig(eig_floor=1e-12, period=None,
                              upper_bounds=(1.0, 1.0))).with_dims(D)
    with torch.no_grad():
        means, conics = field.means.detach(), field.conics()
        rad = oracle.radii(field.covariances(), D, cfg.radius_sigma,
                           cfg.eig_floor)
    if cull:
        rad[::cull] = 0.0
    E = E or 2 * D * nfreq + 1

    def normal(*shape):
        return torch.randn(shape, generator=g, device=dev)

    params = dict(
        features=normal(P, L), transform=0.3 * normal(L, L),
        queries=normal(P, K), keys=normal(P, K),
        frequencies=(0.83 * torch.arange(1, nfreq + 1, dtype=torch.float32,
                                         device=dev)
                     if ladder else normal(nfreq).abs() + 0.5),
        distance_transform=0.5 * normal(2 * E))
    cfg_a, plan = aggregation.plan_pallas(cfg, means, rad)
    if tile_range is not None:
        T = binning.num_tiles(cfg_a, D)
        tile_range = (int(tile_range[0] * T), int(tile_range[1] * T))
    agg = aggregation.preprocess_pallas(
        cfg_a, means, conics, rad, plan, tile_range=tile_range)
    if int(agg.overflow):
        raise AssertionError(f"aggregation overflow {int(agg.overflow)}")
    return cfg_a, (means, conics, rad), params, agg


def agg_operands(params, agg):
    return aggregation.kernel_operands(
        params["features"], params["queries"], params["keys"],
        params["frequencies"], params["distance_transform"], agg)


@contextlib.contextmanager
def rows_per_warp(rows):
    """kernels.aggregate.ROWS_PER_WARP set to ``rows`` for every sweep
    inside the block (None: left as it is)."""
    old = dict(kagg.ROWS_PER_WARP)
    if rows is not None:
        kagg.ROWS_PER_WARP.update({k: rows for k in old})
    try:
        yield
    finally:
        kagg.ROWS_PER_WARP.update(old)


def compare_agg_kernels(agg, params, D, L, K, nfreq, period, ladder, g):
    """The three aggregation kernels against their plain versions on one
    structure's operands and a random cotangent; sentinel centres and
    entries must come back exactly zero.  Returns the errors by kernel."""
    ent_fk, ctr_geo, dtf = agg_operands(params, agg)
    ce, ranges = agg.ctr_ent, (agg.ctr_ent, agg.ent_ctr)
    P = agg.pos.shape[0]                  # the sentinel id
    dead_c, dead_e = agg.cid == P, agg.ent_gid == P
    errs = {"totals": check_close(
        "totals kernel against the plain version",
        kagg.totals(D, period, ce, agg.ent_geo, agg.ctr_static),
        kagg.totals_plain(D, period, ce, agg.ent_geo, agg.ctr_static), RTOL)}
    for with_totals in (False, True):
        got = kagg.forward(D, L, K, nfreq, period, ce, agg.ent_geo, ent_fk,
                           ctr_geo, dtf, ladder=ladder,
                           with_totals=with_totals)
        ref = kagg.forward_plain(D, L, K, nfreq, period, ce, agg.ent_geo,
                                 ent_fk, ctr_geo, dtf, ladder=ladder,
                                 with_totals=with_totals)
        if with_totals:
            errs["forward_totals"] = check_close(
                "forward kernel's totals against the plain version", got[1],
                ref[1], RTOL)
            got, ref = got[0], ref[0]
        if bool((got[dead_c] != 0).any()):
            raise AssertionError("forward: a sentinel centre's row is not 0")
        errs["forward_with_totals" if with_totals else "forward"] = \
            check_close("forward kernel against the plain version", got, ref,
                        RTOL)
    gpre = torch.randn(ctr_geo.shape[0], L, generator=g, device=ctr_geo.device)
    gsum = gpre.sum(dim=1, keepdim=True)
    got = kagg.backward(D, L, K, nfreq, period, ranges, agg.ent_geo, ent_fk,
                        ctr_geo, dtf, gpre, gsum, ladder=ladder)
    ref = kagg.backward_plain(D, L, K, nfreq, period, ranges, agg.ent_geo,
                              ent_fk, ctr_geo, dtf, gpre, gsum, ladder=ladder)
    torch.cuda.synchronize()
    if bool((got[0][:, dead_e] != 0).any() or (got[1][dead_c] != 0).any()):
        raise AssertionError("backward: a sentinel row is not 0")
    E = (dtf.shape[1] - nfreq) // 2
    for name, a, b in (
            ("backward_dfeatures", got[0][:L], ref[0][:L]),
            ("backward_dkeys", got[0][L:], ref[0][L:]),
            ("backward_dqueries", got[1][:, :K], ref[1][:, :K]),
            ("backward_ddt", got[1][:, K:K + 2 * E], ref[1][:, K:K + 2 * E]),
            ("backward_dfreq", got[1][:, K + 2 * E:], ref[1][:, K + 2 * E:])):
        errs[name] = check_close(
            f"{name} kernel against the plain version", a, b, GRAD_RTOL)
    return errs


AGG_SIGMA = {1: 0.02, 2: 0.05, 3: 0.1}    # a few neighbours per centre


def phase_parity_agg(dev, P=3000):
    cases = [(D, period, ladder, L, K, nf, 7, None)
             for D, nf in ((1, 3), (2, 4), (3, 2))
             for period in (2.0, None) for ladder in (False, True)
             for L, K in ((1, 4), (5, 3), (8, 8))]
    cases += [(2, 2.0, False, 5, 3, 1, 0, None),       # nfreq 1
              (3, 2.0, True, 8, 8, 4, 0, None),        # the widest code
              (2, 2.0, True, 12, 20, 2, 5, None),      # L, K above one pass
              (2, 2.0, False, 5, 3, 2, 7, (0.25, 0.6))]   # a tile range
    cases = [c + (None, None, None) for c in cases]
    # The warp sweep's edges (agg_sweep.cuh): rows with more than 32
    # colliding pairs (several drains a row), tiles with a single centre,
    # one and 32 rows a warp, L above the widest partials' pass, nfreq 1
    # and 4, open and wrapped domains, the ladder on and off.
    cases += [(1, 2.0, False, 5, 3, 3, 0, None, 1, 0.2, None),
              (2, None, True, 12, 6, 4, 0, None, 32, 0.05, 0.15),
              (2, 2.0, True, 3, 5, 1, 7, None, 4, 0.004, None),
              (3, None, False, 9, 4, 4, 0, (0.2, 0.7), 32, 0.1, None),
              (2, 2.0, False, 2, 3, 2, 0, None, 1, 0.05, None)]
    sweep_edges = []
    for (D, period, ladder, L, K, nfreq, cull, tile_range, rows, sigma,
         spread) in cases:
        g = torch.Generator(device=dev).manual_seed(90 + D)
        _, _, params, agg = agg_case(
            dev, 80 + D, P, D, L, K, nfreq, sigma or AGG_SIGMA[D],
            period=period, ladder=ladder, cull=cull, tile_range=tile_range,
            spread=spread)
        edges = agg_edges(D, agg)
        if rows is not None:
            sweep_edges.append(edges)
        # The entries are pre-shifted, so the kernels run unwrapped; the
        # wrap itself is held on the same operands (a no-op on them).
        for kernel_period in (None,) if period is None else (None, period):
            with rows_per_warp(rows):
                errs = compare_agg_kernels(agg, params, D, L, K, nfreq,
                                           kernel_period, ladder, g)
            cand, coll = kagg.pair_counts(D, kernel_period, agg.ctr_ent,
                                          agg.ent_geo, agg.ctr_static)
            emit("parity_agg", D=D, period=period,
                 kernel_period=kernel_period, ladder=ladder, L=L, K=K,
                 nfreq=nfreq, P=P, culled_every=cull, tile_range=tile_range,
                 rows_per_warp=rows, rect=agg.rect, candidate_pairs=cand,
                 colliding_pairs=coll, **edges, err=err_fields(errs))
    # A code stride of 2 nfreq + 1 (E = 11 at D = 2, nfreq = 2: columns 4
    # and 9 of each half unused, and never written by the kernel) and the
    # plain versions in chunks of 8 centres (the trailing chunks of pad
    # centres alone are skipped there).
    D, L, K, nfreq = 2, 3, 4, 2
    g = torch.Generator(device=dev).manual_seed(97)
    _, _, params, agg = agg_case(dev, 87, P, D, L, K, nfreq, AGG_SIGMA[D],
                                 cull=7, E=11)
    plain_rows, kagg.PLAIN_ROWS = kagg.PLAIN_ROWS, 8
    try:
        errs = compare_agg_kernels(agg, params, D, L, K, nfreq, None, False,
                                   g)
    finally:
        kagg.PLAIN_ROWS = plain_rows
    emit("parity_agg", D=D, period=2.0, kernel_period=None, ladder=False,
         L=L, K=K, nfreq=nfreq, E=11, P=P, culled_every=7, plain_rows=8,
         rect=agg.rect, err=err_fields(errs))
    # The edges the sweep's cases are for must be present.
    if not (sweep_edges[0]["most_colliding_per_centre"] > 32
            and sweep_edges[1]["most_colliding_per_centre"] > 32
            and sweep_edges[2]["single_centre_tiles"] > 0
            and all(e["empty_centre_rows"] for e in sweep_edges)):
        raise AssertionError(f"parity_agg's sweep cases miss their edges: "
                             f"{sweep_edges}")


def agg_edges(D, agg):
    """What a structure holds for the warp sweep: the most colliding pairs
    of one centre, tiles with a single centre, rows with an empty range."""
    ce = agg.ctr_ent
    row, _, coll = kagg._masked_pairs(D, None, ce, agg.ent_geo,
                                      agg.ctr_static)
    per_centre = torch.bincount(row[coll], minlength=ce.shape[1])
    live = ce[1] > ce[0]
    _, per_tile = torch.unique(ce[0][live], return_counts=True)
    return {"most_colliding_per_centre": int(per_centre.max()),
            "single_centre_tiles": int((per_tile == 1).sum()),
            "empty_centre_rows": int((~live).sum()),
            "empty_entry_rows": int((agg.ent_ctr[1] == agg.ent_ctr[0]).sum())}


def agg_grads(fn, params):
    """(outputs, the six gradients) of sum(out cos(out)), the JAX suite's
    aggregation loss, through fn(*the six groups)."""
    leaves = [params[k].clone().requires_grad_() for k in AGG_GROUPS]
    out = fn(*leaves)
    return out.detach(), torch.autograd.grad((out * torch.cos(out)).sum(),
                                             leaves)


def phase_parity_agg_oracle(dev, P=3000):
    """aggregate_pallas through the kernels against the plain torch table
    path over an untruncated brute-force table; gradients taken twice."""
    for D in (1, 2, 3):
        L, K, nfreq = 5, 3, 2
        cfg, (means, conics, rad), params, agg = agg_case(
            dev, 100 + D, P, D, L, K, nfreq, AGG_SIGMA[D], cull=7)
        nbr = aggregation.preprocess(
            cfg, means, conics, rad,
            aggregation.suggest_capacity(cfg, means, rad))
        if int(nbr.overflow):
            raise AssertionError("the oracle's table is truncated")
        reset_launches()
        out, grads = agg_grads(
            lambda *a: aggregation.aggregate_pallas(*a, agg), params)
        _, again = agg_grads(
            lambda *a: aggregation.aggregate_pallas(*a, agg), params)
        expect_launches("two aggregation steps", agg_forward=2,
                        agg_backward=4, segment_sum=2)
        ref_out, ref = agg_grads(
            lambda *a: aggregation.aggregate(*a, nbr), params)
        err = {"out": check_close(f"aggregate_pallas vs table D={D}", out,
                                  ref_out, RTOL)[0]}
        for name, a, b, r in zip(AGG_GROUPS, grads, again, ref):
            if not torch.equal(a, b):
                raise AssertionError(f"D={D} d{name}: two runs differ")
            scale = max(1.0, float(r.abs().max()))
            diff = (a - r).abs()
            if bool((diff > 1e-4 * scale + GRAD_RTOL * r.abs()).any()):
                raise AssertionError(f"aggregate_pallas grads vs table D={D} "
                                     f"d{name}: max abs err "
                                     f"{float(diff.max())}")
            err[name] = float(diff.max())
        emit("parity_agg_oracle", D=D, P=P, L=L, K=K, nfreq=nfreq,
             neighbor_capacity=nbr.indices.shape[1], max_abs_err=err,
             bitwise_repeatable=True)


AGG_P = 100_000
AGG_DIMS = (2, 8, 8, 4)      # D, L, K, nfreq of the aggregation point


def agg_point(dev, P=AGG_P):
    """The aggregation operating point of tools/bench_aggregate.py: a
    GaussianSampler(method="pallas") preprocessed over the cloud, and the
    six parameter groups: (sampler, params, means)."""
    D, L, K, nfreq = AGG_DIMS
    g = torch.Generator(device=dev).manual_seed(0)
    field = init_field(g, P, D, L, sigma=2.0 / math.sqrt(P))
    with torch.no_grad():
        means, conics = field.means.detach(), field.conics()
        covs = field.covariances()
    E = 2 * D * nfreq + 1

    def normal(*shape):
        return 0.1 * torch.randn(shape, generator=g, device=dev)

    params = dict(
        features=normal(P, L), transform=normal(L, L), queries=normal(P, K),
        keys=normal(P, K),
        frequencies=torch.arange(1, nfreq + 1, dtype=torch.float32,
                                 device=dev),
        distance_transform=normal(2 * E))
    sampler = GaussianSampler(
        config=SamplerConfig(tile_size=0.051, eig_floor=1e-12),
        method="pallas")
    sampler.preprocess(means, params["features"], covs, conics, means[:128])
    return sampler, params, means


def agg_point_calls(sampler, params):
    """(leaves, serve, step) over the structure ``sampler`` holds:
    aggregate_neighbors without gradients, and forward + backward() of
    sum(out^2) to all six groups."""
    leaves = [params[k].clone().requires_grad_() for k in AGG_GROUPS]

    def serve():
        with torch.no_grad():
            return sampler.aggregate_neighbors(*leaves)

    def step():
        for p in leaves:
            p.grad = None
        out = sampler.aggregate_neighbors(*leaves)
        (out * out).sum().backward()
        return out.detach()

    return leaves, serve, step


def sweep_numbers(D, agg):
    """The kernels-line fields of warp_schedule for the warp sweep the
    kernels use (ROWS_PER_WARP rows a warp): the forward's,
    and the backward's over its two sweeps (each pair runs the body in
    both)."""
    n = {sweep: kagg.warp_schedule(
        D, None, agg.ctr_ent, agg.ent_ctr, agg.ent_geo, agg.ctr_static,
        kagg.ROWS_PER_WARP[sweep])[sweep]
        for sweep in kagg.SWEEPS}
    fwd = n["forward"]
    bwd = [n["backward_entries"], n["backward_centres"]]
    steps = sum(b["body_steps"] for b in bwd)
    pairs = {"candidate_pairs": fwd["candidate_pairs"],
             "colliding_pairs": fwd["colliding_pairs"]}
    return {
        "totals": pairs,
        "forward": {**pairs, "body_steps": fwd["body_steps"],
                    "lane_use": fwd["lane_use"],
                    "rows_per_warp": kagg.ROWS_PER_WARP["forward"]},
        "backward": {**pairs, "body_steps": steps,
                     "lane_use": 2 * fwd["colliding_pairs"] / (32 * steps),
                     "by_sweep": {"entries": bwd[0], "centres": bwd[1]},
                     "rows_per_warp": [
                         kagg.ROWS_PER_WARP["backward_entries"],
                         kagg.ROWS_PER_WARP["backward_centres"]]}}


def phase_agg_slice(dev, P=AGG_P):
    """The aggregation operating point of tools/bench_aggregate.py at full
    width, through the facade: structure build, the forward (serving) and
    forward + backward over all six groups."""
    D, L, K, nfreq = AGG_DIMS
    ladder = False      # the facade passes no certificate: the direct code
    sampler, params, means = agg_point(dev, P)

    reset_launches()
    pre_ms = host_ms(lambda: sampler.preprocess_aggregate(method="pallas"), 5)
    # A structure build bins twice (suggest_grid_capacities, then
    # preprocess_grid).
    pre_launches = expect_launches("6 structure builds", agg_totals=6,
                                   binning_keys=12)
    agg = sampler.neighbors
    if int(agg.overflow):
        raise AssertionError(f"aggregation overflow {int(agg.overflow)}")

    leaves, serve, step = agg_point_calls(sampler, params)
    reset_launches()
    fwd_ms = host_ms(serve, 5)
    serve_launches = expect_launches("6 aggregations", agg_forward=6)
    reset_launches()
    step_times = host_ms(step, 5)
    step_launches = expect_launches("6 aggregation steps", agg_forward=6,
                                    agg_backward=12, segment_sum=6)
    out = step()
    grads = [p.grad.clone() for p in leaves]
    if out.shape != (P, L) or not bool(torch.isfinite(out).all()):
        raise AssertionError("aggregate_neighbors: non-finite or misshapen")
    for name, gr, p in zip(AGG_GROUPS, grads, leaves):
        if gr.shape != p.shape or not bool(torch.isfinite(gr).all()):
            raise AssertionError(f"d{name}: non-finite or misshapen")
    step()
    torch.cuda.synchronize()
    repeat = [bool(torch.equal(a, p.grad)) for a, p in zip(grads, leaves)]
    if not all(repeat):
        raise AssertionError(f"gradients differ between two runs: {repeat}")

    # Each kernel against its plain version at full width, the backward on
    # the step's own cotangent, and their times.
    ent_fk, ctr_geo, dtf = agg_operands(params, agg)
    ce, ranges = agg.ctr_ent, (agg.ctr_ent, agg.ent_ctr)
    with torch.no_grad():
        pre = kagg.forward(D, L, K, nfreq, None, ce, agg.ent_geo, ent_fk,
                           ctr_geo, dtf, ladder=ladder)
        gpre = ((2.0 * (pre @ params["transform"])) @ params["transform"].T
                * agg.ctr_static[:, D + 2:D + 3]).contiguous()
        gsum = gpre.sum(dim=1, keepdim=True)
    calls = {
        "totals": (lambda f, lad=False: f(D, None, ce, agg.ent_geo,
                                          agg.ctr_static),
                   kagg.totals, kagg.totals_plain),
        "forward": (lambda f, lad=False: f(
            D, L, K, nfreq, None, ce, agg.ent_geo, ent_fk, ctr_geo, dtf,
            ladder=lad), kagg.forward, kagg.forward_plain),
        "backward": (lambda f, lad=False: f(
            D, L, K, nfreq, None, ranges, agg.ent_geo, ent_fk, ctr_geo, dtf,
            gpre, gsum, ladder=lad), kagg.backward, kagg.backward_plain),
    }
    cand, coll = kagg.pair_counts(D, None, ce, agg.ent_geo, agg.ctr_static)
    numbers, errs, ladder_ms = {}, {}, {}

    def flat(res):                 # the backward's (dent, dctr) as one vector
        return (torch.cat([r.reshape(-1) for r in res])
                if isinstance(res, tuple) else res)

    for name, (call, kernel, plain) in calls.items():
        got, ref = flat(call(kernel)), flat(call(plain))
        errs[name] = check_close(
            f"{name} kernel against the plain version at full width", got,
            ref, GRAD_RTOL if name == "backward" else RTOL)
        ms = cuda_ms(lambda: call(kernel))
        plain_ms = cuda_ms(lambda: call(plain), reps=3)
        # totals reads the centres' mean and radius columns only.
        operands = {"totals": (agg.ent_geo, agg.ctr_static[:, :D + 1], ce),
                    "forward": (agg.ent_geo, ent_fk, ctr_geo, dtf, ce),
                    "backward": (agg.ent_geo, ent_fk, ctr_geo, dtf, gpre,
                                 gsum, ce, agg.ent_ctr)}[name]
        moved = sum(t.numel() for t in operands) + got.numel()
        numbers[name] = {
            "max_abs_err": errs[name][0], "ms": ms, "plain_ms": plain_ms,
            **agg_bound(name, cand, coll, moved, D, L, K, nfreq, ladder)}
        if name != "totals":
            # The frequencies are the integer ladder: the certified
            # (recurrence) path on the same operands, beside its own bound.
            got, ref = flat(call(kernel, True)), flat(call(plain, True))
            errs[name + "_ladder"] = check_close(
                f"{name} ladder kernel against the plain version at full "
                "width", got, ref, GRAD_RTOL if name == "backward" else RTOL)
            ladder_ms[name] = {
                "max_abs_err": errs[name + "_ladder"][0],
                "ms": cuda_ms(lambda: call(kernel, True)),
                **agg_bound(name, cand, coll, moved, D, L, K, nfreq, True)}
    for name, counts in sweep_numbers(D, agg).items():
        numbers[name].update(counts)
    emit("agg_slice", P=P, D=D, L=L, K=K, nfreq=nfreq, ladder=ladder,
         tile=aggregation.plan_pallas(sampler.config, means,
                                      sampler.radii)[0].tile_size,
         rect=agg.rect,
         entries=int((agg.ent_gid < P).sum()), candidate_pairs=cand,
         colliding_pairs=coll, overflow=int(agg.overflow),
         launches={"preprocess": pre_launches, "serve": serve_launches,
                   "steps": step_launches},
         grads_bitwise_repeatable=True, err=err_fields(errs),
         kernel_ms={k: v["ms"] for k, v in numbers.items()},
         plain_ms={k: v["plain_ms"] for k, v in numbers.items()},
         bound_ms={k: v["bound_ms"] for k, v in numbers.items()},
         ladder_kernels=ladder_ms,
         preprocess_ms_median=statistics.median(pre_ms), preprocess_ms=pre_ms,
         forward_ms_median=statistics.median(fwd_ms), forward_ms=fwd_ms,
         step_ms_median=statistics.median(step_times), step_ms=step_times)
    return pre_launches, serve_launches, step_launches, numbers, step


DYN_P, DYN_EVAL, DYN_ROLLOUT = 100_000, 65_536, 2
DYN_CFG = dict(eig_floor=1e-12, tile_size=0.51, axis_radii=True,
               ellip_cull=True)


def phase_dynamics(dev, P=DYN_P, steps=60, n_eval=DYN_EVAL):
    """The dynamics trainer at config 4 (phase B of tools/train_100k.py)."""
    import inspect

    fit_steps = inspect.signature(dynamics.fit_values).parameters[
        "steps"].default
    reset_launches()
    t0 = time.perf_counter()
    params, history = dynamics.train(
        SamplerConfig(**DYN_CFG), P=P, D=2, steps=steps, rollout=DYN_ROLLOUT,
        sigma=3.0 * 2.0 / math.sqrt(P), n_eval=n_eval, method="pallas",
        eval_method="tiled", log_every=max(steps // 6, 1),
        ladder_frequencies=True, scan_chunk=10, device=dev)
    wall = time.perf_counter() - t0
    # The value fit takes fit_steps steps of the tiled kernels and each of
    # the two evaluators probes a fresh batch once; then per step: one
    # aggregation forward and one backward (two entry points) per rollout
    # depth, and one tiled evaluation of the stacked depths.  Its six
    # binnings are all made before the first step (as many at 10 steps).
    launches = expect_launches(
        f"{steps} dynamics steps", agg_totals=1,
        agg_forward=DYN_ROLLOUT * steps, agg_backward=2 * DYN_ROLLOUT * steps,
        tiled_forward=fit_steps + 2 + steps, tiled_backward=fit_steps + steps,
        segment_sum=DYN_ROLLOUT * steps + fit_steps + steps, binning_keys=6)
    for h in history:
        if h["nbr_overflow"] or h["eval_overflow"]:
            raise AssertionError(f"overflow at step {h['step']}: {h}")
    first, last = history[0]["loss"], history[-1]["loss"]
    if not (math.isfinite(last) and last < first):
        raise AssertionError(f"dynamics loss did not fall: {first} -> {last}")
    if params.frequencies.shape != (1,):
        raise AssertionError("the ladder's base is not a (1,) parameter")
    emit("dynamics", P=P, D=2, steps=steps, rollout=DYN_ROLLOUT,
         n_eval=n_eval, fit_steps=fit_steps,
         t_step_s_warm=min(h["t_step_s"] for h in history[1:]),
         t_step_s=[h["t_step_s"] for h in history], wall_s=round(wall, 3),
         loss_first=first, loss_last=last,
         loss_curve=[h["loss"] for h in history],
         loss_steps=[h["step"] for h in history], launches=launches,
         launches_per_step={"agg_forward": DYN_ROLLOUT,
                            "agg_backward": 2 * DYN_ROLLOUT,
                            "tiled_forward": 1, "tiled_backward": 1})
    return launches


def dynamics_structure(dev, P=DYN_P):
    """Config 4's cloud, aggregation structure and untrained parameters,
    built as dynamics.train builds them from seed 0 (without the value
    fit, which moves no geometry): (cfg, gen, field, nbr, params)."""
    cfg = SamplerConfig(**DYN_CFG)
    gen = torch.Generator(device=dev).manual_seed(0)
    field = init_field(gen, P, 2, 1, sigma=3.0 * 2.0 / math.sqrt(P))
    with torch.no_grad():
        means, conics = field.means.detach(), field.conics()
        rad = oracle.radii(field.covariances(), 2, cfg.radius_sigma,
                           cfg.eig_floor)
    cfg_a, plan = aggregation.plan_pallas(cfg, means, rad)
    nbr = aggregation.preprocess_pallas(cfg_a, means, conics, rad, plan)
    params = dynamics.init_dynamics_params(gen, P, 1, 2, ladder=True)
    return cfg, gen, field, nbr, params


def dynamics_groups(field, params, nfreq=2):
    """The aggregation's parameter groups as the dynamics step hands them
    to the kernels: the field's values as features, the frequencies the
    ladder that rollout_step builds from the (1,) base."""
    with torch.no_grad():
        return dict(
            features=field.values.detach(), queries=params.queries.detach(),
            keys=params.keys.detach(),
            frequencies=params.frequencies.detach()[0] * torch.arange(
                1, nfreq + 1, dtype=torch.float32,
                device=field.values.device),
            distance_transform=params.distance_transform.detach())


def phase_parity_dynamics(dev, P=DYN_P):
    """The aggregation kernels against their plain versions on the
    operands the dynamics step gives them at full width: L = 1, K = 4,
    nfreq = 2 with the ladder recurrence, the sigma * 3 structure."""
    D, L, nfreq = 2, 1, 2
    _, gen, field, nbr, params = dynamics_structure(dev, P)
    if int(nbr.overflow):
        raise AssertionError(f"aggregation overflow {int(nbr.overflow)}")
    K = params.queries.shape[1]
    groups = dynamics_groups(field, params, nfreq)
    errs = compare_agg_kernels(nbr, groups, D, L, K, nfreq, None, True, gen)
    # The untrained parameters are small, so the absolute floor of
    # check_close is loose here: also hold each result's largest error
    # against its reference's largest magnitude.
    for name, (_, rel) in errs.items():
        if rel > (GRAD_RTOL if name.startswith("backward") else RTOL):
            raise AssertionError(f"parity_dynamics {name}: max abs err is "
                                 f"{rel} of max|ref|")
    cand, coll = kagg.pair_counts(D, None, nbr.ctr_ent, nbr.ent_geo,
                                  nbr.ctr_static)
    ent_fk, ctr_geo, dtf = agg_operands(groups, nbr)
    gpre = torch.randn(ctr_geo.shape[0], L, generator=gen, device=dev)
    gsum = gpre.sum(dim=1, keepdim=True)
    ranges = (nbr.ctr_ent, nbr.ent_ctr)
    calls = {"forward": lambda: kagg.forward(
                 D, L, K, nfreq, None, nbr.ctr_ent, nbr.ent_geo, ent_fk,
                 ctr_geo, dtf, ladder=True),
             "backward": lambda: kagg.backward(
                 D, L, K, nfreq, None, ranges, nbr.ent_geo, ent_fk, ctr_geo,
                 dtf, gpre, gsum, ladder=True)}
    operands = {"forward": (nbr.ent_geo, ent_fk, ctr_geo, dtf, nbr.ctr_ent),
                "backward": (nbr.ent_geo, ent_fk, ctr_geo, dtf, gpre, gsum,
                             nbr.ctr_ent, nbr.ent_ctr)}
    numbers = {}
    for kind, call in calls.items():
        res = call()
        res = res if isinstance(res, tuple) else (res,)
        moved = sum(t.numel() for t in operands[kind] + res)
        ms = cuda_ms(call)
        bound = agg_bound(kind, cand, coll, moved, D, L, K, nfreq, True)
        numbers[kind] = {"ms": ms, **bound, "share": bound["bound_ms"] / ms}
    for kind, counts in sweep_numbers(D, nbr).items():
        if kind in numbers:
            numbers[kind].update(counts)
    dent = calls["backward"]()[0]
    numbers["segment_sum"] = segment_numbers(dent, nbr.ent_gid, P,
                                             nbr.rect ** D)
    emit("parity_dynamics", P=P, D=D, L=L, K=K, nfreq=nfreq, ladder=True,
         rect=nbr.rect, entries=int((nbr.ent_gid < P).sum()),
         candidate_pairs=cand, colliding_pairs=coll, err=err_fields(errs),
         kernel_ms={k: v["ms"] for k, v in numbers.items()},
         kernels=numbers)
    return numbers["segment_sum"]


def dynamics_step(dev, P=DYN_P, n_eval=DYN_EVAL):
    """One dynamics training step at config 4, built as dynamics.train
    builds it (without the value fit), for the profile."""
    cfg, gen, field, nbr, params = dynamics_structure(dev, P)
    opt = torch.optim.Adam(list(params), lr=3e-3, eps=1e-8)
    eval_u = dynamics.make_value_eval(cfg, field, "tiled", n_eval=n_eval,
                                      with_overflow=True, padded=True)
    return dynamics.make_train_step(
        params, opt, field.values.detach(), nbr, eval_u,
        dynamics.advection_diffusion_solution(2), gen, n_eval=n_eval,
        rollout=DYN_ROLLOUT, dt=0.05, ladder=True, padded=True)


def pigs_setup(dev):
    """Config 4's field and capacities as pigs.train sets them up from seed
    0: (cfg, field, generator, u_star, f_rhs)."""
    u_star, f_rhs = pigs.manufactured_solution(2)
    gen = torch.Generator(device=dev).manual_seed(0)
    field = init_field(gen, PIGS_P, 2, 1, sigma=2.0 / math.sqrt(PIGS_P))
    probe = 2.0 * torch.rand((PIGS_COLLOCATION, 2), generator=gen,
                             device=dev) - 1.0
    cfg = pigs.auto_config(SamplerConfig(**PIGS_CFG), field, probe, PIGS_P)
    return cfg, field, gen, u_star, f_rhs


def pigs_step(dev):
    """One PIGS training step at config 4, built as pigs.train builds it."""
    cfg, field, gen, u_star, f_rhs = pigs_setup(dev)
    opt = torch.optim.Adam(field.parameters(), lr=PIGS_LR, eps=1e-8)
    step = pigs.make_train_step(cfg, opt, f_rhs, u_star, gen,
                                n_collocation=PIGS_COLLOCATION)
    return lambda: step(field)


def tiled_evaluations(t):
    """The tiled evaluations in the autograd graph under ``t``, each as the
    operands its two kernels were (and will be) launched with: a list of
    dicts (orders, period, D, C, geom, smp, state, the entries' gid, P and
    slots for the segment-sum, and the kernel modes: separable, moments,
    folded, fold_dv, fold_vjp, hmm, passes; under a mode geom is tile-local
    and smp the monomial operand; under folded, fold and foldw)."""
    seen, stack, found = set(), [t.grad_fn], []
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        if type(fn).__name__ == "_TiledForwardBackward":
            saved = fn.saved_tensors
            geom, smp, gid = saved[:3]
            separable, moments, folded, fold_dv, fold_vjp, hmm = fn.modes
            found.append(dict(orders=fn.orders, period=fn.kernel_period,
                              D=fn.D, C=fn.C, geom=geom.detach(), smp=smp,
                              state=fn.state, gid=gid, P=fn.P,
                              slots=fn.slots, separable=separable,
                              moments=moments, folded=folded,
                              fold_dv=fold_dv, fold_vjp=fold_vjp, hmm=hmm,
                              fold=saved[3].detach() if folded else None,
                              foldw=saved[4] if folded else None,
                              passes=fn.passes))
        stack.extend(f for f, _ in fn.next_functions)
    return found


def path_cases(dev):
    """The operands the trainers' tiled evaluations hand the two kernels at
    full width, taken from the autograd graph of one loss of each path:
    PIGS config 4's collocation (value + laplacian, C = 1, wrapped) and data
    (value, C = 1) evaluations, and the dynamics step's value evaluation
    (C = rollout = 2 over the reused Gaussian-side binning)."""
    cases = {}
    cfg, field, gen, u_star, f_rhs = pigs_setup(dev)
    kw = dict(generator=gen, device=dev)
    collocation = 2.0 * torch.rand((PIGS_COLLOCATION, 2), **kw) - 1.0
    data_x = 2.0 * torch.rand((PIGS_COLLOCATION // 4, 2), **kw) - 1.0
    loss, _ = pigs.pigs_loss(cfg, field, collocation, data_x, u_star(data_x),
                             f_rhs)
    for ev in tiled_evaluations(loss):
        cases["pigs_collocation" if "laplacian" in ev["orders"]
              else "pigs_data"] = ev

    gen = torch.Generator(device=dev).manual_seed(0)
    field = init_field(gen, DYN_P, 2, 1, sigma=3.0 * 2.0 / math.sqrt(DYN_P))
    eval_u = dynamics.make_value_eval(
        SamplerConfig(**DYN_CFG), field, "tiled", n_eval=DYN_EVAL,
        with_overflow=True, padded=True)
    values = torch.randn((DYN_P, DYN_ROLLOUT), **kw).requires_grad_()
    u = eval_u(values, 2.0 * torch.rand((DYN_EVAL, 2), **kw) - 1.0)[0]
    (cases["dynamics_eval"],) = tiled_evaluations(u)
    if sorted(cases) != ["dynamics_eval", "pigs_collocation", "pigs_data"]:
        raise AssertionError(f"tiled evaluations found: {sorted(cases)}")
    return cases


def phase_parity_paths(dev):
    """Both tiled kernels against their plain versions on the operands the
    PIGS step and the dynamics step give them, at full width (the headline
    instantiation is held at full width by slice and train_step), with the
    kernels' times and bounds at those shapes, and the segment-sum on the
    backward's rows there."""
    numbers = {}
    for name, ev in path_cases(dev).items():
        orders, period, D, C = ev["orders"], ev["period"], ev["D"], ev["C"]
        geom, smp, state = ev["geom"], ev["smp"], ev["state"]
        lo, n = ktiled.entry_ranges(state, smp.shape[1])
        s_lo, s_n = ktiled.sample_ranges(state, geom.shape[1])
        K = ktiled.total_unique(orders, D)
        gen = torch.Generator(device=dev).manual_seed(7)
        ct = torch.randn((K * C, smp.shape[1]), generator=gen, device=dev)
        fwd = lambda f: f(orders, period, D, C, geom, smp, lo, n)
        bwd = lambda f: f(orders, period, D, C, geom, smp, ct, s_lo, s_n)
        got, got_b = fwd(ktiled.tiled_forward), bwd(ktiled.tiled_backward)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = fwd(ktiled.tiled_forward_plain)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ref_b = bwd(ktiled.tiled_backward_plain)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        errs = compare(got, ref, orders, D, C)
        errs_b = compare_rows(got_b, ref_b, D, C)
        # check_close's absolute floor is loose where max|ref| is small:
        # also hold each group's largest error against max|ref|.
        for what, e, tol in [(o, errs[o], RTOL) for o in errs] + [
                (g, errs_b[g], GRAD_RTOL) for g in errs_b]:
            if e[1] > tol:
                raise AssertionError(f"parity_paths {name} {what}: max abs "
                                     f"err is {e[1]} of max|ref|")
        pads = check_dead_rows("forward", got, smp[D] < 0)
        dead = check_dead_rows("backward", got_b, dead_entries(geom, state))
        pairs, entries = pair_counts(state)
        numbers[name] = {}
        for side, kernel, call, moved in (
                ("forward", "tiled_forward", fwd, (geom, smp, lo, n, got)),
                ("backward", "tiled_backward", bwd,
                 (geom, smp, ct, s_lo, s_n, got_b))):
            ms = cuda_ms(lambda: call(getattr(ktiled, kernel)))
            bound = kernel_bound(pairs, sum(t.numel() for t in moved), D,
                                 orders, C, period is not None,
                                 side == "backward")
            numbers[name][kernel] = {
                "ms": ms, **bound, "share": bound["bound_ms"] / ms,
                "plain_ms": 1e3 * ((t1 - t0) if side == "forward"
                                   else (t2 - t1)),
                "kept_pairs": pairs,
                "swept_pairs": swept_pairs(state, side),
                **instantiation(kernel, orders, D, C, period)}
        numbers[name]["segment_sum"] = segment_numbers(
            got_b, ev["gid"], ev["P"], ev["slots"])
        emit("parity_paths", path=name, orders=list(orders), D=D, C=C,
             wrapped=period is not None, samples=int(state.s_perm.shape[0]),
             entries=entries, pairs=pairs, pad_columns_zero=pads,
             sentinel_columns_zero=dead, **tile_facts(state),
             err=err_fields(errs), bwd_err=err_fields(errs_b),
             **numbers[name])
    return numbers


def host_ms(fn, reps):
    """Per-call synchronised host-clock times of fn(), after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


CHUNKED_CFG = dict(tile_size=0.2, eig_floor=1e-12, axis_radii=True,
                   ellip_cull=True)
CHUNKED_P, CHUNKED_N = 100_000, 1_000_000


def chunked_field(dev, P, N, D=3, C=4, sigma=None, seed=0):
    """A seeded field (sigma 2 / P^(1/D) unless given: bench.py's D = 3
    workload) and N uniform samples on [-1, 1)^D: ((means, values, covs,
    conics), samples)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    field = init_field(g, P, D, C, sigma=sigma or 2.0 / P ** (1.0 / D))
    samples = 2.0 * torch.rand((N, D), generator=g, device=dev) - 1.0
    with torch.no_grad():
        return (field.means.detach(), field.values.detach(),
                field.covariances(), field.conics()), samples


def chunked_loss(cfg, plan, cs, covs, samples, orders, params):
    """The bench loss over the chunked op (bench.py:195-214): the
    multiplicity-weighted sum of squares of the padded, sorted, unique
    outputs over N, as a closure of ``params`` (means, values, conics);
    returns (loss, diagnostics)."""
    D, N = samples.shape[1], samples.shape[0]
    mult = {o: torch.tensor(formulas.sym_multiplicity(o, D),
                            dtype=torch.float32, device=samples.device)
            for o in orders}

    def loss_fn():
        outs, diag = sampling_chunked.sample_chunked(
            cfg, params[0], params[1], params[2], covs, samples, plan, cs,
            orders, padded_outputs=True)
        return sum(torch.einsum("ucn,u->", o * o, mult[k])
                   for k, o in outs.items()) / N, diag

    return loss_fn


def chunked_sampler(dev, P=CHUNKED_P, N=CHUNKED_N, preprocess_reps=1):
    """GaussianSampler(method="chunked") preprocessed on bench.py's D = 3
    workload (chunked_field), the field and samples made once; returns the
    sampler and the preprocess times (ms, synchronised host clock: the plan
    and the sample side)."""
    (means, values, covs, conics), samples = chunked_field(dev, P, N)
    sampler = GaussianSampler(config=SamplerConfig(**CHUNKED_CFG),
                              method="chunked")
    pre = host_ms(lambda: sampler.preprocess(means, values, covs, conics,
                                             samples), preprocess_reps)
    return sampler, pre


def chunked_step(sampler, orders):
    """The D = 3 chunked training step over a preprocessed chunked facade's
    own tensors, planned config, plan and sample side: each step bins the
    Gaussians anew, runs the fused forward of ``orders`` and backward() to
    means, values and conics.  Returns (step, loss_fn, params)."""
    params = [t.detach().clone().requires_grad_()
              for t in (sampler.means, sampler.values, sampler.conics)]
    loss_fn = chunked_loss(sampler.config, sampler._chunk_plan,
                           sampler._chunk_samples, sampler.covariances,
                           sampler.samples, orders, params)

    def step():
        for p in params:
            p.grad = None
        loss, diag = loss_fn()
        loss.backward()
        return loss.detach(), diag

    return step, loss_fn, params


def check_segment(rows, gid, P):
    """The segment-sum kernel against its plain version, bitwise, on
    per-entry rows as the backward kernel hands them."""
    g_sorted, order = torch.sort(gid, stable=True)
    starts = torch.searchsorted(
        g_sorted, torch.arange(P + 1, dtype=g_sorted.dtype,
                               device=gid.device), out_int32=True)
    got = segment.segment_sum(rows, order, starts)
    ref = segment.segment_sum_plain(rows.contiguous(), order, starts)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError("segment_sum kernel and plain version differ "
                             "on the chunked path's rows")


def chunked_kernels(ev, ct, plain=True):
    """Kernels 1-2 (and the segment-sum) on the operands of one chunked
    evaluation (``ev`` from tiled_evaluations) and the cotangent ``ct``:
    each against its plain version (``plain``), pad and sentinel columns
    exactly 0; returns ({"forward": errs, "backward": errs}, the forward's
    output, the backward's rows, the operands' sizes, plain seconds)."""
    orders, period, D, C = ev["orders"], ev["period"], ev["D"], ev["C"]
    geom, smp, state = ev["geom"], ev["smp"], ev["state"]
    lo, n = ktiled.entry_ranges(state, smp.shape[1])
    s_lo, s_n = ktiled.sample_ranges(state, geom.shape[1])
    got = ktiled.tiled_forward(orders, period, D, C, geom, smp, lo, n)
    got_b = ktiled.tiled_backward(orders, period, D, C, geom, smp, ct,
                                  s_lo, s_n)
    check_segment(got_b, ev["gid"], ev["P"])
    errs, plain_s = {}, {}
    if plain:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = ktiled.tiled_forward_plain(orders, period, D, C, geom, smp, lo,
                                         n)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ref_b = ktiled.tiled_backward_plain(orders, period, D, C, geom, smp,
                                            ct, s_lo, s_n)
        torch.cuda.synchronize()
        plain_s = {"forward": t1 - t0, "backward": time.perf_counter() - t1}
        errs = {"forward": compare(got, ref, orders, D, C),
                "backward": compare_rows(got_b, ref_b, D, C)}
        del ref, ref_b
    check_dead_rows("forward", got, smp[D] < 0)
    check_dead_rows("backward", got_b, dead_entries(geom, state))
    moved = {"forward": sum(t.numel() for t in (geom, smp, lo, n, got)),
             "backward": sum(t.numel() for t in (geom, smp, ct, s_lo, s_n,
                                                 got_b))}
    return errs, got, got_b, moved, plain_s


def chunked_operands(dev, seed, D, P, N, C, sigma, cfg_kw):
    """A seeded chunked case, planned: its tensors with conics computed
    from the covariances (binning.conics_from_cov, the conics the tiled
    build culls with, so that the two paths cull alike), the planned
    config, the plan and the sample side."""
    (means, values, covs, _), samples = chunked_field(
        dev, P, N, D=D, C=C, sigma=sigma, seed=seed)
    conics = binning.conics_from_cov(covs, D)
    cfg, plan = sampling_chunked.plan_chunked(
        SamplerConfig(**cfg_kw).with_dims(D), means, covs, samples)
    cs = sampling_chunked.chunk_samples(cfg, samples, plan, cfg.block_n)
    return (means, values, covs, conics), samples, cfg, plan, cs


def phase_parity_chunked(dev, P=5000, N=50_000):
    """The chunked op on the card against the tiled op on the same inputs
    (outputs and gradients), kernels 1-2 and the segment-sum against their
    plain versions on the chunked op's own operands, and the first 512
    samples of the D = 3 bench-flag case against the dense masked
    oracle."""
    cases = [(D, unwrapped, dict(tile_size=0.1275, eig_floor=1e-12), 0.03)
             for D in (1, 2, 3) for unwrapped in (False, True)]
    # bench.py's D = 3 flags and footprints (sigma of the full-width field).
    cases.append((3, True, CHUNKED_CFG, 2.0 / CHUNKED_P ** (1.0 / 3.0)))
    for i, (D, unwrapped, cfg_kw, sigma) in enumerate(cases):
        (means, values, covs, conics), samples, cfg, plan, cs = \
            chunked_operands(dev, 60 + i, D, P, N, 4, sigma, cfg_kw)
        if unwrapped and not cfg.unwrapped_kernels:
            raise AssertionError(f"D={D}: the plan does not certify the "
                                 "unwrapped kernels for this case")
        cfg = dataclasses.replace(cfg, unwrapped_kernels=unwrapped)
        orders = ORDERS if D < 3 or cfg_kw is CHUNKED_CFG else SLICE_ORDERS
        params = [t.clone().requires_grad_() for t in (means, values, conics)]
        outs, diag = sampling_chunked.sample_chunked(
            cfg, params[0], params[1], params[2], covs, samples, plan, cs,
            orders)
        diag = {k: int(v) for k, v in diag.items() if k != "perm"}
        if any(diag.values()):
            raise AssertionError(f"chunked diagnostics not zero: {diag}")
        loss = sum((o * o).sum() for o in outs.values())
        (ev,) = tiled_evaluations(loss)
        grads = torch.autograd.grad(loss, params)

        # The tiled op over its own binning of the same Gaussians, with the
        # plan's candidate cap and room for every entry.
        tcfg = dataclasses.replace(
            cfg, max_tiles_per_gaussian=plan.rect,
            entry_capacity_factor=plan.entries / P + 1.0)
        state = binning.build(tcfg, means, covs, samples)
        tparams = [t.clone().requires_grad_() for t in (means, values,
                                                        conics)]
        touts = sampling.sample_tiled_multi(
            orders, tcfg, *tparams, samples, state, unwrapped=unwrapped)
        tgrads = torch.autograd.grad(sum((o * o).sum() for o in touts),
                                     tparams)
        err = {o: check_close(f"chunked vs tiled D={D} {o}", outs[o].detach(),
                              t.detach(), RTOL)[0]
               for o, t in zip(orders, touts)}
        for name, a, b in zip(("means", "values", "conics"), grads, tgrads):
            err[f"d{name}"] = check_close(f"chunked vs tiled D={D} d{name}",
                                          a, b, GRAD_RTOL)[0]

        K = ktiled.total_unique(orders, D)
        gen = torch.Generator(device=dev).manual_seed(70 + i)
        ct = torch.randn((K * 4, ev["smp"].shape[1]), generator=gen,
                         device=dev)
        kerr = chunked_kernels(ev, ct)[0]
        fields = dict(D=D, unwrapped=unwrapped, P=P, N=N, C=4,
                      orders=list(orders), tile=cfg.tile_size,
                      axis_radii=cfg.axis_radii, ellip_cull=cfg.ellip_cull,
                      rect=plan.rect, entries_planned=plan.entries,
                      entries=pair_counts(ev["state"])[1],
                      pairs=pair_counts(ev["state"])[0],
                      max_abs_err_vs_tiled=err,
                      kernel_err=err_fields(kerr["forward"]),
                      kernel_bwd_err=err_fields(kerr["backward"]))
        if cfg_kw is CHUNKED_CFG:
            # An independent reference: the dense oracle under the chunked
            # binning's pair mask, on the first 512 samples.
            n_ref = 512
            mask = binning.pair_mask_dense(cfg, ev["state"], samples[:n_ref],
                                           P)
            fields["oracle_max_abs_err"] = {
                o: check_close(
                    f"chunked vs oracle D={D} {o}", outs[o][:n_ref].detach(),
                    oracle.evaluate(o, means, values, conics, samples[:n_ref],
                                    period=cfg.period, pair_mask=mask),
                    RTOL)[0] for o in orders}
            fields["oracle_samples"] = n_ref
        emit("parity_chunked", **fields)


def chunked_numbers(dev, orders, sampler, evals=10, steps=10, plain=True):
    """One order set of the chunked slice over a preprocessed chunked
    facade: evaluations through it, training steps over its own tensors and
    plan (chunked_step), the kernels against their plain versions on the
    step's own operands, times, bounds, device busy time and peak memory."""
    step, loss_fn, params = chunked_step(sampler, orders)
    cfg, plan, samples = sampler.config, sampler._chunk_plan, sampler.samples
    D, C, N = 3, 4, samples.shape[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    e2e = host_ms(lambda: sampler.sample_all(orders), evals)
    eval_launches = expect_launches(f"{evals + 1} chunked evaluations",
                                    tiled_forward=evals + 1,
                                    binning_keys=evals + 1)
    outs = sampler.sample_all(orders)
    want = {"value": [N, C], "derivative": [N, D, C],
            "laplacian": [N, D, D, C], "third": [N, D, D, D, C]}
    shapes = {o: list(outs[o].shape) for o in orders}
    if shapes != {o: want[o] for o in orders}:
        raise AssertionError(f"output shapes {shapes}")
    for o in orders:
        if not bool(torch.isfinite(outs[o]).all()):
            raise AssertionError(f"non-finite {o} output")
    del outs

    reset_launches()
    step_times = host_ms(step, steps)
    step_launches = expect_launches(
        f"{steps + 1} chunked training steps", tiled_forward=steps + 1,
        tiled_backward=steps + 1, segment_sum=steps + 1,
        binning_keys=steps + 1)
    loss, diag = step()
    loss = float(loss)
    grads = [p.grad.clone() for p in params]
    diag = {k: int(v) for k, v in diag.items() if k != "perm"}
    if any(diag.values()):
        raise AssertionError(f"chunked diagnostics not zero: {diag}")
    for name, gr, p in zip(("means", "values", "conics"), grads, params):
        if gr.shape != p.shape or not bool(torch.isfinite(gr).all()):
            raise AssertionError(f"d{name}: non-finite or misshapen")
    step()
    torch.cuda.synchronize()
    repeat = [bool(torch.equal(a, p.grad)) for a, p in zip(grads, params)]
    if not all(repeat):
        raise AssertionError(f"gradients differ between two runs: {repeat}")
    peak = torch.cuda.max_memory_allocated()
    busy, top, _ = device_busy(step, 5)

    # The kernels on the step's own operands and cotangent (d loss / d
    # packed outputs = 2 / N * multiplicity * packed).
    (ev,) = tiled_evaluations(loss_fn()[0])
    state = ev["state"]
    with torch.no_grad():
        lo, n = ktiled.entry_ranges(state, ev["smp"].shape[1])
        packed = ktiled.tiled_forward(orders, ev["period"], D, C, ev["geom"],
                                      ev["smp"], lo, n)
        w = torch.cat([torch.tensor(formulas.sym_multiplicity(o, D),
                                    dtype=torch.float32, device=dev
                                    ).repeat_interleave(C) for o in orders])
        ct = (2.0 / N) * w[:, None] * packed
        del packed
        errs, got, got_b, moved, plain_s = chunked_kernels(ev, ct, plain)
    pairs = pair_count(state.ent_tile.cpu(), state.ent_start.shape[0] - 2,
                       state.s_tile.cpu())
    if pairs != pair_counts(state)[0]:
        raise AssertionError("pair_count disagrees with the tile ranges")
    entries = pair_counts(state)[1]
    period, geom, smp = ev["period"], ev["geom"], ev["smp"]
    s_lo, s_n = ktiled.sample_ranges(state, geom.shape[1])
    kernels = {}
    for side, kernel, call in (
            ("forward", "tiled_forward", lambda: ktiled.tiled_forward(
                orders, period, D, C, geom, smp, lo, n)),
            ("backward", "tiled_backward", lambda: ktiled.tiled_backward(
                orders, period, D, C, geom, smp, ct, s_lo, s_n))):
        ms = cuda_ms(call)
        bound = kernel_bound(pairs, moved[side], D, orders, C,
                             period is not None, side == "backward")
        kernels[kernel] = {
            "ms": ms, **bound, "share": bound["bound_ms"] / ms,
            "plain_ms": 1e3 * plain_s[side] if plain else None,
            "max_abs_err": (max(e[0] for e in errs[side].values())
                            if plain else None),
            "kept_pairs": pairs, "swept_pairs": swept_pairs(state, side),
            **instantiation(kernel, orders, D, C, period)}
    seg = segment_numbers(got_b, ev["gid"], ev["P"], ev["slots"])
    fields = dict(
        orders=list(orders), P=sampler.means.shape[0], N=N, D=D, C=C,
        tile=cfg.tile_size, axis_radii=cfg.axis_radii,
        ellip_cull=cfg.ellip_cull, unwrapped_kernels=cfg.unwrapped_kernels,
        rect=plan.rect, entries_planned=plan.entries, entries=entries,
        pairs=pairs, diagnostics=diag, output_shapes=shapes,
        launches={"evaluations": eval_launches, "steps": step_launches},
        grads_bitwise_repeatable=True, loss=loss,
        err={s: err_fields(e) for s, e in errs.items()},
        kernels=kernels, segment_sum=seg,
        e2e_ms_median=statistics.median(e2e), e2e_ms_min=min(e2e),
        e2e_ms_max=max(e2e), e2e_ms=e2e,
        step_ms_median=statistics.median(step_times),
        step_ms_min=min(step_times), step_ms_max=max(step_times),
        step_ms=step_times, device_busy_ms_per_step=busy,
        idle_share=max(0.0, 1.0 - busy / statistics.median(step_times)),
        top=top, peak_bytes=peak,
        roofline=step_roofline(orders, D, C, pairs, N, entries))
    return fields, eval_launches, step_launches, step


def phase_chunked_slice(dev, P=CHUNKED_P, N=CHUNKED_N):
    """The chunked path at the full width of bench.py's D = 3 workload
    through GaussianSampler(method="chunked"), value + derivative +
    laplacian and then all four orders: preprocess, evaluations, training
    steps (chunked_numbers), one field, plan and sample side for all.
    Returns the launches, the numbers by order count and the 3-order
    training step (for phase_profile)."""
    sampler, pre = chunked_sampler(dev, P, N, preprocess_reps=3)
    out, launches = {}, {"chunked_slice": {}, "chunked_step": {}}
    for orders in (SLICE_ORDERS, ORDERS):
        fields, ev_l, st_l, step = chunked_numbers(dev, orders, sampler)
        emit("chunked_slice", preprocess_ms_median=statistics.median(pre),
             preprocess_ms=pre, **fields)
        out[len(orders)] = fields
        for path, got in (("chunked_slice", ev_l), ("chunked_step", st_l)):
            for k, v in got.items():
                launches[path][k] = launches[path].get(k, 0) + v
        if orders == SLICE_ORDERS:
            slice_step = step
    return launches, out, slice_step


def phase_profile(dev, train_step, dense_step, agg_step, chunked_train_step,
                  pigs_iters=10):
    """Where a step's time goes: device busy time per step under the
    profiler against the unprofiled step time (median, synchronised host
    clock), for the headline training step, the PIGS config 4 step, the
    dense training step, the aggregation step, the dynamics config 4 step
    and the D = 3 chunked training step (value + derivative +
    laplacian)."""
    for path, fn, iters in (("train_step", train_step, 5),
                            ("pigs", pigs_step(dev), pigs_iters),
                            ("dense_step", dense_step, 3),
                            ("agg_step", agg_step, 5),
                            ("dynamics", dynamics_step(dev), pigs_iters),
                            ("chunked_step", chunked_train_step, 5)):
        times = host_ms(fn, 2 * iters)
        busy, top, items = device_busy(fn, iters)
        step_ms = statistics.median(times)
        emit("profile", path=path, step_ms_median=step_ms, step_ms=times,
             device_busy_ms_per_step=busy, device_items_per_step=items,
             idle_share=max(0.0, 1.0 - busy / step_ms), top=top)


def tiled_times(dev, reps=10, steps=30):
    """The two tiled kernels, through their wrappers, at every shape the
    tiled paths launch them with, and the three tiled steps (python3
    chip_smoke.py --tiled).  Kernel shapes: the headline training step's
    operands, PIGS config 4's two evaluations, the dynamics evaluation
    (path_cases), and D = 3 with all four orders and C = 4: the parity case
    (5,000 x 50,000, wrapped) and the same field at 100,000 x 1,000,000
    (unwrapped).  Steps: the headline training step, the PIGS config 4 step
    and the dynamics config 4 step, ``steps`` synchronised host-clock times
    each.  Device times differ between cards and host times between
    machines by more than a redesign gains, so two trees are compared by
    running this script's --tiled in each of them on one card, one after
    the other, in turns (first, second, second, first)."""
    step, _, (means, values, covs, conics), samples, cfg, sb, _, _ = \
        headline_step(dev, 100_000, 1_000_000)
    state = binning.build(cfg, means, covs, samples, sample_binning=sb)
    geom, smp, _, _ = operands(state, (means, values, conics), samples, cfg)
    cases = {"headline": dict(
        orders=SLICE_ORDERS, D=2, C=4, geom=geom, smp=smp, state=state,
        period=None if cfg.unwrapped_kernels else cfg.period)}
    cases.update(path_cases(dev))
    for name, unwrapped, P, N in (("d3_parity", False, 5000, 50_000),
                                  ("d3_wide", True, 100_000, 1_000_000)):
        _, state, geom, smp, period, _, _, _ = small_case(
            dev, 13, 3, unwrapped, 0.03, 4, P_small=P, N_small=N)
        cases[name] = dict(orders=ORDERS, D=3, C=4, geom=geom, smp=smp,
                           state=state, period=period)
    for name, ev in cases.items():
        orders, period, D, C = ev["orders"], ev["period"], ev["D"], ev["C"]
        geom, smp, state = ev["geom"], ev["smp"], ev["state"]
        lo, n = ktiled.entry_ranges(state, smp.shape[1])
        s_lo, s_n = ktiled.sample_ranges(state, geom.shape[1])
        gen = torch.Generator(device=dev).manual_seed(7)
        ct = torch.randn((ktiled.total_unique(orders, D) * C, smp.shape[1]),
                         generator=gen, device=dev)
        pairs, entries = pair_counts(state)
        emit("tiled_times", shape=name, orders=list(orders), D=D, C=C,
             wrapped=period is not None, entries=entries,
             samples=int(state.s_perm.shape[0]), pairs=pairs,
             forward_ms=cuda_ms(lambda: ktiled.tiled_forward(
                 orders, period, D, C, geom, smp, lo, n), reps),
             backward_ms=cuda_ms(lambda: ktiled.tiled_backward(
                 orders, period, D, C, geom, smp, ct, s_lo, s_n), reps),
             forward_bound_ms=kernel_bound(
                 pairs, 0, D, orders, C, period is not None,
                 False)["bound_ms"],
             backward_bound_ms=kernel_bound(
                 pairs, 0, D, orders, C, period is not None,
                 True)["bound_ms"])
    for path, fn in (("train_step", step), ("pigs", pigs_step(dev)),
                     ("dynamics", dynamics_step(dev))):
        times = host_ms(fn, steps)
        emit("tiled_steps", path=path, step_ms_median=statistics.median(times),
             step_ms_min=min(times), step_ms_max=max(times))
    emit("spin", **_spin)


def chunked_times(dev, steps=30):
    """The chunked path's times alone (python3 chip_smoke.py --chunked): at
    the full width of bench.py's D = 3 workload, for value + derivative +
    laplacian and for all four orders, ``steps`` evaluations through the
    facade and ``steps`` training steps (synchronised host clock), device
    busy time per step, and kernels 1-2 and the segment-sum through their
    wrappers on a step's operands, beside their bounds (chunked_numbers
    without the plain versions).  Two trees are compared by running this
    in each of them in turns, as --tiled."""
    sampler, pre = chunked_sampler(dev)
    for orders in (SLICE_ORDERS, ORDERS):
        fields = chunked_numbers(dev, orders, sampler, evals=steps,
                                 steps=steps, plain=False)[0]
        emit("chunked_times", preprocess_ms=pre, **fields)
    emit("spin", **_spin)


PIGS_DENSE_P, PIGS_DENSE_COLLOCATION = 10_000, 16_384


def pigs_dense_step(dev, P=PIGS_DENSE_P, n_collocation=PIGS_DENSE_COLLOCATION):
    """One PIGS training step through the dense kernels, built as
    pigs.train(method="pallas") builds it for phase pigs_dense."""
    u_star, f_rhs = pigs.manufactured_solution(2)
    gen = torch.Generator(device=dev).manual_seed(0)
    field = init_field(gen, P, 2, 1, sigma=2.0 / math.sqrt(P))
    opt = torch.optim.Adam(field.parameters(), lr=PIGS_LR, eps=1e-8)
    step = pigs.make_train_step(
        SamplerConfig(**{**PIGS_CFG, "tile_size": 0.125}), opt, f_rhs, u_star,
        gen, n_collocation=n_collocation, method="pallas")
    return lambda: step(field)


def dense_times(dev, reps=10, steps=30):
    """The two dense kernels, through their wrappers, at every shape the
    dense paths launch them with, and the two dense steps (python3
    chip_smoke.py --dense).  Kernel shapes: dense config 2 (10,000 x
    100,000, D = 3, C = 4, all four orders) wrapped (period 2.0, as the
    facade runs it) and unwrapped, and the PIGS dense step's collocation
    (value + laplacian, 16,384 points) and data (value, 4,096 points)
    evaluations at P = 10,000, D = 2, C = 1, period 2.0; each with its
    bound, share, registers and waves (blocks over the blocks the card
    holds at once).  Steps: the dense config 2 training step and the PIGS
    dense step, ``steps`` synchronised host-clock times each.  Then the
    segment-sum's peak memory at D = 3, R = 8, P = 100,000.  Two trees are
    compared by running this script's --dense in each of them on one card,
    in turns (first, second, second, first)."""
    (m, v, c, s), _, period, _, _, config2_step = dense_config2(dev)
    g = torch.Generator(device=dev).manual_seed(11)
    field = init_field(g, PIGS_DENSE_P, 2, 1,
                       sigma=2.0 / math.sqrt(PIGS_DENSE_P))
    with torch.no_grad():
        pm, pv, pc = field.means.detach(), field.values.detach(), \
            field.conics()
    points = {n: 2.0 * torch.rand((n, 2), generator=g, device=dev) - 1.0
              for n in (PIGS_DENSE_COLLOCATION, PIGS_DENSE_COLLOCATION // 4)}
    cases = {
        "config2_wrapped": (ORDERS, period, (m, v, c, s)),
        "config2_unwrapped": (ORDERS, None, (m, v, c, s)),
        "pigs_collocation": (("value", "laplacian"), period,
                             (pm, pv, pc, points[PIGS_DENSE_COLLOCATION])),
        "pigs_data": (("value",), period,
                      (pm, pv, pc, points[PIGS_DENSE_COLLOCATION // 4])),
    }
    for name, (orders, per, args) in cases.items():
        (P, C), (N, D) = args[1].shape, args[3].shape
        K = kdense.total_components(orders, D)
        gs = list(torch.randn((K, N, C), generator=g, device=dev))
        operand_floats = sum(t.numel() for t in args) + K * N * C
        row = {}
        for kernel, call, floats in (
                ("dense_forward", lambda: kdense.dense_forward(
                    orders, per, *args), operand_floats),
                ("dense_backward", lambda: kdense.dense_backward(
                    orders, per, *args, gs),
                 operand_floats + P * (D + D * (D + 1) // 2 + C))):
            ms = cuda_ms(call, reps)
            bound = kernel_bound(N * P, floats, D, orders, C,
                                 per is not None, kernel == "dense_backward")
            inst = dense_instantiation(kernel, orders, D, C, per)
            blocks = dense_blocks(kernel, P, N)
            row[kernel] = {"ms": ms, **bound,
                           "share": bound["bound_ms"] / ms, "blocks": blocks,
                           "waves": blocks / (132 * inst["resident_blocks"]),
                           **inst}
        emit("dense_times", shape=name, orders=list(orders), D=D, C=C, P=P,
             N=N, wrapped=per is not None, pairs=N * P, **row)
    for path, fn in (("dense_step", config2_step),
                     ("pigs_dense", pigs_dense_step(dev))):
        times = host_ms(fn, steps)
        emit("dense_steps", path=path, step_ms_median=statistics.median(times),
             step_ms_min=min(times), step_ms_max=max(times))
    segment_memory(dev)
    emit("spin", **_spin)


# The binning's key kernel's work a candidate tile, in FP32 / integer
# instructions, estimated by hand and not counted: the rect, the
# candidate's tests and its tile id (all candidates); and at D axes the
# cull's 4 D sweep steps (D - 1 products and sums, a clamp, one IEEE
# division: one SFU reciprocal and about 8 instructions of refinement), its
# box and its form (candidates inside the rect, which reach the cull).  It
# leaves out address arithmetic, the lanes a warp idles while others cull,
# and the division's slow path; key_build_facts counts the instantiations'
# SASS instructions beside it.
KEY_OPS = 50


def cull_ops(D):
    return 4 * D * (2 * (D - 1) + 3 + 8) + 4 * D + 3 * D * D


def key_build_facts():
    """The key kernel's instantiations from the build: ptxas registers and
    spill bytes, whether fast-math was on, and the instructions of each
    instantiation's SASS (cuobjdump beside nvcc; null where it fails)."""
    log = _build.build_log()
    ptxas = [dict(D=int(D), registers=int(regs),
                  spill_store_bytes=int(spill))
             for D, spill, regs in re.findall(
                 r"Compiling entry function '\S*binning_keys_kernelILi(\d)"
                 r"\S*'[\s\S]*?(\d+) bytes spill stores[\s\S]*?"
                 r"Used (\d+) registers", log)]
    sass = None
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    try:
        dump = subprocess.run([tool, "-sass", _build._OUT],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
    except (OSError, subprocess.SubprocessError):
        dump = None
    if dump is not None:
        sass = {}
        for fn in re.split(r"\n\s*Function : ", dump)[1:]:
            m = re.match(r"\S*binning_keys_kernelILi(\d)", fn)
            if m:
                sass[int(m.group(1))] = len(re.findall(
                    r"/\*[0-9a-f]{4,}\*/\s+(?!NOP\b)[@A-Z]", fn))
    return dict(ptxas=ptxas, fast_math="use_fast_math" in log,
                sass_instructions=sass)


@contextlib.contextmanager
def key_operands():
    """The operands (cfg, means, radii, R, conics) of every key kernel
    launch made inside the block, in order, as candidate_keys hands them to
    launch_keys (the launches still run)."""
    calls, real = [], binning.launch_keys

    def spy(lib, cfg, means, radii, R, conics, *rest):
        calls.append((cfg, means, radii, R, conics))
        return real(lib, cfg, means, radii, R, conics, *rest)

    binning.launch_keys = spy
    try:
        yield calls
    finally:
        binning.launch_keys = real


def keys_parity(case, cfg, means, radii, R, conics):
    """candidate_keys (the kernel) against candidate_keys_plain on the same
    CUDA operands: keys and rect overflow bitwise equal, or raise; the
    case's fields."""
    launches = binning.candidate_keys.launches
    got = binning.candidate_keys(cfg, means, radii, R, conics)
    if binning.candidate_keys.launches != launches + 1:
        raise AssertionError(f"binning_keys {case}: the kernel did not run")
    want = binning.candidate_keys_plain(cfg, means, radii, R, conics)
    for a, b, what in zip(got, want, ("keys", "overflow")):
        if not torch.equal(a, b):
            raise AssertionError(f"binning_keys {case}: {what} differ from "
                                 "candidate_keys_plain")
    P, D = means.shape
    T = binning.num_tiles(cfg, D)
    tiles = (got[0] >> P.bit_length() if binning.key_packed(P, T)
             else got[0])
    return dict(case=case, D=D, P=P, R=R, radii=list(radii.shape),
                conics=conics is not None, periodic=cfg.period is not None,
                candidates=tiles.numel(), kept=int((tiles < T).sum()),
                overflow=int(got[1]), bitwise=True)


def binning_keys_numbers(cfg, means, rad, con, R):
    """The key kernel on one operand set: bitwise against
    candidate_keys_plain, then CUDA-event ms of each and of
    duplicate_entries each way, and the kernel's bound (bytes read and
    written once; KEY_OPS and cull_ops instructions of the candidates, the
    cull's only inside the rects)."""
    P, D = means.shape
    dup = R ** D
    fields = keys_parity("d3_chunked", cfg, means, rad, R, con)
    lo, hi = binning.gaussian_rects(cfg, means, rad)
    in_rect = int(torch.prod(torch.clamp(hi - lo, min=0, max=R), dim=1).sum())
    E_cap = P * dup
    kernel_keys = binning.candidate_keys
    ms = cuda_ms(lambda: binning.candidate_keys(cfg, means, rad, R, con))
    plain_ms = cuda_ms(
        lambda: binning.candidate_keys_plain(cfg, means, rad, R, con))
    entries_ms = cuda_ms(lambda: binning.duplicate_entries(
        cfg, means, rad, R, E_cap, conics=con))
    try:
        binning.candidate_keys = (lambda c, m, r, k, q=None:
                                  binning.candidate_keys_plain(c, m, r, k, q))
        entries_plain_ms = cuda_ms(lambda: binning.duplicate_entries(
            cfg, means, rad, R, E_cap, conics=con))
    finally:
        binning.candidate_keys = kernel_keys
    n_bytes = 4 * (P * (D + rad[0].numel() + con.shape[1]) + P * dup + 1)
    t_bytes = n_bytes / MEM_BYTES_S
    t_ops = max((P * dup * KEY_OPS + in_rect * cull_ops(D)) / FP32_INSTR_S,
                in_rect * 4 * D / SFU_OPS_S)
    bound_ms = 1e3 * max(t_bytes, t_ops)
    return dict(fields, in_rect=in_rect, ms=ms, plain_ms=plain_ms,
                duplicate_entries_ms=entries_ms,
                duplicate_entries_plain_ms=entries_plain_ms,
                bound_ms=bound_ms,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                share=bound_ms / ms)


def d3_key_operands(dev):
    """tools.bench's D = 3 chunked workload (100k Gaussians of init_field,
    1M samples, tile 0.2, axis radii, the cull), planned, and what each of
    its steps hands duplicate_entries: (cfg, means, radii, conics, R)."""
    _, w = modes_workload(dev, {})
    cfg, means, rad, con, R, _ = bench.entry_operands(w)
    return cfg, means, rad, con, R


def phase_parity_binning(dev):
    """The binning's key kernel bitwise against candidate_keys_plain at the
    operands each main path hands it (captured from the path's own call):
    the D = 2 headline's binning, the aggregation structure's
    (periodic, and the same operands in an open domain) and the D = 3
    chunked workload.  Returns the kernels line's numbers, on the last."""
    t0 = time.perf_counter()
    cases = []
    (means, values, covs, conics), samples, cfg, _ = headline(
        dev, 100_000, 1_000_000)
    with key_operands() as calls:
        GaussianSampler(config=cfg).preprocess(means, values, covs, conics,
                                               samples)
    cases += [("headline_d2", *calls[0])]
    del means, values, covs, conics, samples
    sampler, _, _ = agg_point(dev)
    with key_operands() as calls:
        sampler.preprocess_aggregate(method="pallas")
    acfg, *rest = calls[-1]        # preprocess_grid's, as the path runs
    open_cfg = dataclasses.replace(
        acfg, period=None, upper_bounds=tuple(lo + 2.0 for lo in acfg.lower))
    cases += [("agg_periodic", acfg, *rest), ("agg_open", open_cfg, *rest)]
    del sampler
    for case in cases:
        emit("parity_binning", **keys_parity(*case))
    cfg, means, rad, con, R = d3_key_operands(dev)
    numbers = dict(binning_keys_numbers(cfg, means, rad, con, R),
                   **key_build_facts())
    emit("parity_binning", **numbers, seconds=time.perf_counter() - t0)
    return numbers


def binning_times(dev):
    """The binning's key kernel (csrc/binning_keys.cu) alone (python3
    chip_smoke.py --binning): its build facts, then on tools.bench's D = 3
    chunked workload at R = 4 and 5, bitwise against its plain version, its
    CUDA-event ms beside the plain chain's, duplicate_entries' each way and
    its bound."""
    emit("binning_keys_build", **key_build_facts())
    cfg, means, rad, con, plan_R = d3_key_operands(dev)
    for R in (4, 5):
        emit("binning_keys", plan_R=plan_R,
             **binning_keys_numbers(cfg, means, rad, con, R))
    emit("spin", **_spin)


def segment_times(dev):
    """The segment-sum (segment_numbers: both layouts, index_add_,
    segment_sum_rows as a whole, the sort) on the per-entry rows of every
    shape a path gives it, each from its backward kernel on a random
    cotangent (python3 chip_smoke.py --segment): the headline training
    step (tiled backward, 321,920 entries x 9 rows), the synthetic D = 3,
    R = 8 case of segment_memory, a real D = 3 binning at 100,000 x
    1,000,000 (segment_d3_rows) and the dynamics step's aggregation
    backward (L + K = 5 rows).  Two trees are compared by running this
    script's --segment in each of them on one card, in turns."""
    P, D, C = 100_000, 2, 4
    _, _, (means, values, covs, conics), samples, cfg, sb, _, _ = \
        headline_step(dev, P, 1_000_000, C)
    state = binning.build(cfg, means, covs, samples, sample_binning=sb)
    geom, smp, _, _ = operands(state, (means, values, conics), samples, cfg)
    s_lo, s_n = ktiled.sample_ranges(state, geom.shape[1])
    g = torch.Generator(device=dev).manual_seed(7)
    ct = torch.randn((ktiled.total_unique(SLICE_ORDERS, D) * C,
                      smp.shape[1]), generator=g, device=dev)
    rows = ktiled.tiled_backward(
        SLICE_ORDERS, None if cfg.unwrapped_kernels else cfg.period, D, C,
        geom, smp, ct, s_lo, s_n)
    gid = ktiled.prepare_entries(state, means, values, conics, ktiled.BLOCK_E,
                                 cfg=cfg)[0]
    emit("segment_times", case="headline", **segment_numbers(
        rows, gid, P, cfg.max_tiles_per_gaussian ** D))
    fields, rows, gid = segment_memory(dev)
    emit("segment_times", case="d3_r8", **segment_numbers(
        rows, gid, fields["P"], fields["slots"]))
    emit("segment_times", case="d3_real",
         **segment_numbers(*segment_d3_rows(dev)))
    _, gen, field, nbr, dparams = dynamics_structure(dev)
    L, K, nfreq = 1, dparams.queries.shape[1], 2
    ent_fk, ctr_geo, dtf = agg_operands(
        dynamics_groups(field, dparams, nfreq), nbr)
    gpre = torch.randn((ctr_geo.shape[0], L), generator=gen, device=dev)
    dent, _ = kagg.backward(D, L, K, nfreq, None, (nbr.ctr_ent, nbr.ent_ctr),
                            nbr.ent_geo, ent_fk, ctr_geo, dtf, gpre,
                            gpre.sum(dim=1, keepdim=True), ladder=True)
    emit("segment_times", case="dynamics_agg", **segment_numbers(
        dent, nbr.ent_gid, DYN_P, nbr.rect ** D))
    emit("spin", **_spin)


def agg_instantiation(kernel, D, L, K, nfreq, ladder):
    """{"registers", "shared_bytes", "spill_bytes"} of the aggregation
    kernel ("totals", "forward", "backward_entries", "backward_centres")
    that the shapes launch (unwrapped), from the ptxas report of the
    build."""
    lad = int(ladder)
    name = {"totals": f"agg_totals_kernelILi{D}ELb0EE",
            "forward": f"agg_forward_kernelILi{D}ELb{lad}ELb0ELi"
                       f"{8 if L > 4 else 4}EE",
            "backward_entries": f"agg_backward_entries_kernelILi{D}ELb{lad}"
                                f"ELi{16 if L + K > 8 else 8}EE",
            "backward_centres": f"agg_backward_centres_kernelILi{D}ELi"
                                f"{nfreq}ELb{lad}ELi{8 if K > 4 else 4}EE",
            }[kernel]
    reports = [
        r for r in _build.build_log().split("Compiling entry function")[1:]
        if name in r.split("'")[1]]
    if len(reports) != 1:
        raise AssertionError(f"{len(reports)} ptxas reports for {name}")
    smem = re.search(r"(\d+) bytes smem", reports[0])
    spill = re.search(r"(\d+) bytes spill stores", reports[0])
    return {"registers": int(re.search(r"Used (\d+) registers",
                                       reports[0]).group(1)),
            "shared_bytes": int(smem.group(1)) if smem else 0,
            "spill_bytes": int(spill.group(1)) if spill else 0}


def agg_shapes(dev):
    """The aggregation point's sampler and parameters, and both shapes of
    kernels 5-7: {shape: (structure, groups, D, L, K, nfreq, ladder)}."""
    sampler, params, _ = agg_point(dev)
    point_agg = sampler.preprocess_aggregate(method="pallas")
    _, _, field, nbr, dparams = dynamics_structure(dev)
    nfreq = 2
    dyn_groups = dynamics_groups(field, dparams, nfreq)
    return sampler, params, {
        "aggregation_point": (point_agg, params, *AGG_DIMS, False),
        "dynamics": (nbr, dyn_groups, 2, 1, dparams.queries.shape[1], nfreq,
                     True)}


def agg_schedules(shapes):
    """warp_schedule's counts of the warp sweep at each shape, at 1 to 32
    rows a warp."""
    for shape, (agg, _, D, *_) in shapes.items():
        for rows in (1, 2, 4, 8, 16, 32):
            emit("agg_schedule", shape=shape, rows_per_warp=rows,
                 **kagg.warp_schedule(D, None, agg.ctr_ent, agg.ent_ctr,
                                      agg.ent_geo, agg.ctr_static, rows))


def agg_times(dev, reps=10, steps=30):
    """Kernels 5-7 through their wrappers at the aggregation point and at
    the dynamics shapes, and the aggregation and dynamics steps (python3
    chip_smoke.py --agg).  Per shape: warp_schedule's counts of the warp
    sweep at 1 to 32 rows a warp; each kernel's time (CUDA events, median
    of ``reps``), bound, share, registers, resident blocks and waves; the
    backward's split between its two kernels (device time under the
    profiler).  Steps: ``steps`` synchronised host-clock times each and
    device busy ms (device_busy).  Two trees are compared by running
    this script's --agg in each of them on one card, in turns (first,
    second, second, first)."""
    rows_tree = kagg.ROWS_PER_WARP
    sampler, params, shapes = agg_shapes(dev)
    agg_schedules(shapes)
    for shape, (agg, groups, D, L, K, nfreq, ladder) in shapes.items():
        ent_fk, ctr_geo, dtf = agg_operands(groups, agg)
        ce, ranges = agg.ctr_ent, (agg.ctr_ent, agg.ent_ctr)
        g = torch.Generator(device=dev).manual_seed(5)
        gpre = torch.randn((ctr_geo.shape[0], L), generator=g, device=dev)
        gsum = gpre.sum(dim=1, keepdim=True)
        cand, coll = kagg.pair_counts(D, None, ce, agg.ent_geo,
                                      agg.ctr_static)

        def fwd():
            return kagg.forward(D, L, K, nfreq, None, ce, agg.ent_geo,
                                ent_fk, ctr_geo, dtf, ladder=ladder)

        def bwd():
            return kagg.backward(D, L, K, nfreq, None, ranges, agg.ent_geo,
                                 ent_fk, ctr_geo, dtf, gpre, gsum,
                                 ladder=ladder)

        def split():
            """The backward's device ms per call by kernel."""
            _, top, _ = device_busy(bwd, reps)
            return {k: sum(t for n, t in top if f"agg_backward_{k}" in n)
                    for k in ("entries", "centres")}

        moved = {"totals": agg.ent_geo.numel() + ctr_geo.shape[0] * (D + 2)
                 + ce.numel(),
                 "forward": sum(t.numel() for t in (
                     agg.ent_geo, ent_fk, ctr_geo, dtf, ce))
                 + ctr_geo.shape[0] * L,
                 "backward": sum(t.numel() for t in (
                     agg.ent_geo, ent_fk, ctr_geo, dtf, gpre, gsum, ce,
                     agg.ent_ctr)) + sum(t.numel() for t in bwd())}
        def tot():
            return kagg.totals(D, None, ce, agg.ent_geo, agg.ctr_static)

        row = {}
        for kind, call, kernels in (
                ("totals", tot, ("totals",)),
                ("forward", fwd, ("forward",)),
                ("backward", bwd, ("backward_entries", "backward_centres"))):
            ms = cuda_ms(call, reps)
            bound = agg_bound(kind, cand, coll, moved[kind], D, L, K, nfreq,
                              ladder)
            row[kind] = {"ms": ms, **bound, "share": bound["bound_ms"] / ms}
            for k in kernels:
                inst = agg_instantiation(k, D, L, K, nfreq, ladder)
                n_rows = (agg.ent_geo.shape[1] if k == "backward_entries"
                          else ctr_geo.shape[0])
                per_block = 128 if k == "totals" else 4 * rows_tree[k]
                blocks = -(-n_rows // per_block)
                resident = resident_blocks(inst["registers"], 128,
                                           inst["shared_bytes"])
                row[kind][k] = {**inst, "blocks": blocks,
                                "resident_blocks": resident,
                                "waves": blocks / (132 * resident)}
        row["backward"]["split_ms"] = split()
        emit("agg_times", shape=shape, D=D, L=L, K=K, nfreq=nfreq,
             ladder=ladder, centres=ctr_geo.shape[0],
             entries=agg.ent_geo.shape[1], candidate_pairs=cand,
             colliding_pairs=coll, rows_per_warp=rows_tree, **row)
    _, _, agg_step = agg_point_calls(sampler, params)
    for path, fn in (("agg_step", agg_step),
                     ("dynamics", dynamics_step(dev))):
        times = host_ms(fn, steps)
        busy, top, _ = device_busy(fn, 10)
        emit("agg_steps", path=path, step_ms_median=statistics.median(times),
             step_ms_min=min(times), step_ms_max=max(times),
             device_busy_ms_per_step=busy, top=top)
    emit("spin", **_spin)


# ---------------------------------------------------------------------------
# The sharded paths (dgs_tpu_torch/parallel/mesh.py)
# ---------------------------------------------------------------------------

SHARD_PIGS_STEPS = 3


def clone_field(field):
    with torch.no_grad():
        return GaussianField(*(p.detach().clone() for p in (
            field.means, field.log_scales, field.rotations, field.values)))


def pigs_draws(gen, dev, n):
    """``n`` steps' (collocation, data points) of config 4, drawn as
    pigs.make_train_step draws them."""
    draws = []
    for _ in range(n):
        col = 2.0 * torch.rand((PIGS_COLLOCATION, 2), generator=gen,
                               device=dev) - 1.0
        dx = 2.0 * torch.rand((PIGS_COLLOCATION // 4, 2), generator=gen,
                              device=dev) - 1.0
        draws.append((col, dx))
    return draws


def agg_grads_of(fn, params):
    """(output, the six gradients) of sum(out^2) through
    fn(features, transform, queries, keys, frequencies, distance_transform)
    on fresh leaves of ``params``."""
    leaves = [params[k].clone().requires_grad_() for k in AGG_GROUPS]
    out = fn(*leaves)
    (out * out).sum().backward()
    return out.detach(), [p.grad for p in leaves]


def agg_shard_inputs(sampler):
    """(cfg, means, conics, radii) of the aggregation point's facade."""
    return (sampler.config, sampler.means.detach(), sampler.conics.detach(),
            sampler.radii)


def bitwise(what, got, ref):
    if not torch.equal(got, ref):
        raise AssertionError(
            f"{what}: not bitwise equal, max abs diff "
            f"{float((got - ref).abs().max())}")


def phase_sharded(dev):
    """sharded: the paths of parallel/mesh.py on one NCCL rank in this
    process (mesh (1, 1) on "cuda"): sharded_sample_all at the headline
    (tiled, three orders), SHARD_PIGS_STEPS replicated and model-sharded
    PIGS steps of config 4 and sharded_aggregate at the aggregation point,
    each held bitwise against its unsharded path on the same inputs
    (sample_binned, pigs.train_step, aggregate_pallas); then their times,
    one NCCL all-reduce's time at the sizes the paths reduce, and peak
    memory."""
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            return sharded_one_rank(dev)
        finally:
            dist.destroy_process_group()


def sharded_one_rank(dev):
    mesh = pm.make_mesh((1, 1), "cuda")
    # Inputs and the unsharded references first: their launches are not
    # the sharded path's.
    (means, values, covs, conics), samples, cfg, _ = headline(
        dev, 100_000, 1_000_000)
    gauss = (means, values, conics, covs)
    # At one rank the per-shard plan is the whole cloud's.
    cfg_sh = pm.plan_sharded_config(SamplerConfig(**HEADLINE), mesh, means,
                                    covs, samples)
    if cfg_sh != cfg:
        raise AssertionError(f"plan_sharded_config at one rank: {cfg_sh} "
                             f"!= {cfg}")
    ref_outs, _ = sampling.sample_binned(cfg, means, values, conics, covs,
                                         samples, SLICE_ORDERS)
    pcfg, field0, gen, u_star, f_rhs = pigs_setup(dev)
    draws = pigs_draws(gen, dev, SHARD_PIGS_STEPS)
    ref_field = clone_field(field0)
    ref_opt = torch.optim.Adam(ref_field.parameters(), lr=PIGS_LR, eps=1e-8)
    ref_losses = [pigs.train_step(pcfg, ref_field, ref_opt, c, x, u_star(x),
                                  f_rhs)["loss"] for c, x in draws]
    sampler, params, _ = agg_point(dev)
    sampler.preprocess_aggregate(method="pallas")
    ref_agg = agg_grads_of(sampler.aggregate_neighbors, params)

    rep_field = clone_field(field0)
    rep_opt = torch.optim.Adam(rep_field.parameters(), lr=PIGS_LR, eps=1e-8)
    rep_step = pm.make_sharded_pigs_step(pcfg, mesh, f_rhs, u_star)
    mod_step, shard_field = pm.make_model_sharded_pigs_step(
        pcfg, mesh, f_rhs, u_star)
    mod_field = shard_field(field0)
    mod_opt = torch.optim.Adam(mod_field.parameters(), lr=PIGS_LR, eps=1e-8)

    reset_launches()
    outs, diag = pm.sharded_sample_all(cfg, mesh, *gauss, samples,
                                       SLICE_ORDERS)
    rep_metrics = [rep_step(rep_field, rep_opt, c, x) for c, x in draws]
    mod_metrics = [mod_step(mod_field, mod_opt, c, x) for c, x in draws]
    _, _, agg = pm.build_sharded_aggregation(
        *agg_shard_inputs(sampler), 1, 0)
    sh_agg = agg_grads_of(
        lambda *leaves: pm.sharded_aggregate(mesh, *leaves, agg), params)
    torch.cuda.synchronize()
    k = SHARD_PIGS_STEPS
    # The binnings: the evaluation's, two a PIGS step of each kind, and
    # three of the sharded aggregation structure.
    launches = expect_launches(
        "the sharded paths at one rank", tiled_forward=1 + 4 * k,
        tiled_backward=4 * k, segment_sum=4 * k + 1, agg_totals=1,
        agg_forward=1, agg_backward=2, binning_keys=1 + 4 * k + 3)

    over = {k: int(diag[k]) for k in pigs.DIAGNOSTICS if int(diag[k])}
    if over or int(agg.overflow):
        raise AssertionError(f"sharded overflow {over}, aggregation "
                             f"{int(agg.overflow)}")
    for order in SLICE_ORDERS:
        bitwise(f"sharded_sample_all {order}", outs[order], ref_outs[order])
    for i, (ref, rep, mod) in enumerate(zip(ref_losses, rep_metrics,
                                            mod_metrics)):
        bitwise(f"replicated PIGS loss, step {i}", rep["loss"], ref)
        bitwise(f"model-sharded PIGS loss, step {i}", mod["loss"], ref)
        for name in pigs.DIAGNOSTICS:
            if int(rep[name]) or int(mod[name]):
                raise AssertionError(f"PIGS step {i}: {name}")
    for name, p in ref_field.named_parameters():
        bitwise(f"replicated PIGS {name}", getattr(rep_field, name), p)
        bitwise(f"model-sharded PIGS {name}", getattr(mod_field, name), p)
    bitwise("sharded_aggregate output", sh_agg[0], ref_agg[0])
    for name, g, r in zip(AGG_GROUPS, sh_agg[1], ref_agg[1]):
        bitwise(f"sharded_aggregate d{name}", g, r)
    n_eval = sum(o.numel() for o in outs.values())
    del ref_outs, outs

    # Times: each sharded path beside its unsharded one, and the bare
    # all-reduce at the sizes the paths hand NCCL (device time, and the
    # synchronised host time of one call).
    def peak(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated()

    def sharded_eval():
        pm.sharded_sample_all(cfg, mesh, *gauss, samples, SLICE_ORDERS)

    def eval_():
        sampling.sample_binned(cfg, means, values, conics, covs, samples,
                               SLICE_ORDERS)

    c0, x0 = draws[0]
    times = {
        "eval": host_ms(eval_, 5), "sharded_eval": host_ms(sharded_eval, 5),
        "pigs_step": host_ms(lambda: pigs.train_step(
            pcfg, ref_field, ref_opt, c0, x0, u_star(x0), f_rhs), 5),
        "sharded_pigs_step": host_ms(
            lambda: rep_step(rep_field, rep_opt, c0, x0), 5),
        "model_sharded_pigs_step": host_ms(
            lambda: mod_step(mod_field, mod_opt, c0, x0), 5),
        "agg_step": host_ms(
            lambda: agg_grads_of(sampler.aggregate_neighbors, params), 5),
        "sharded_agg_step": host_ms(lambda: agg_grads_of(
            lambda *leaves: pm.sharded_aggregate(mesh, *leaves, agg),
            params), 5)}
    n_pigs = PIGS_COLLOCATION * 4          # value + 3 unique Hessian terms
    n_grads = sum(p.numel() for p in ref_field.parameters())
    allreduce_ms = {}
    for what, n in (("eval_outputs", n_eval), ("pigs_outputs", n_pigs),
                    ("pigs_grads", n_grads),
                    ("agg_outputs", ref_agg[0].numel())):
        buf = torch.zeros(n, device=dev)
        allreduce_ms[what] = {
            "floats": n, "ms": cuda_ms(lambda: dist.all_reduce(buf)),
            "host_ms": statistics.median(host_ms(
                lambda: dist.all_reduce(buf), 10))}
    busy = {}
    for what, fn in (("eval", eval_), ("sharded_eval", sharded_eval)):
        ms, top, _ = device_busy(fn, 5)
        busy[what] = {"device_busy_ms": ms, "top": top}
    emit("sharded", backend="nccl", mesh=[1, 1], P=100_000, N=1_000_000,
         orders=SLICE_ORDERS, pigs_steps=k, agg_P=AGG_P,
         bitwise_equal_to_unsharded=True, launches=launches,
         losses=[float(x) for x in ref_losses],
         ms_median={k: statistics.median(v) for k, v in times.items()},
         ms=times, allreduce_ms=allreduce_ms, device_busy=busy,
         peak_bytes={"eval": peak(eval_), "sharded_eval": peak(sharded_eval)})
    return launches


def sharded_two_ranks_worker(rank, store, out_dir):
    """One of the two ranks of phase_sharded_two_ranks, on card 0 under
    gloo; writes its results to out_dir/rank<rank>.json."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=2)
    try:
        res = sharded_two_ranks(dev)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def sharded_two_ranks(dev):
    mesh = pm.make_mesh((1, 2), "cuda")
    m = mesh.get_local_rank("model")
    # gloo's all-reduce takes CUDA tensors (staged through host memory).
    probe = torch.full((4,), float(m + 1), device=dev)
    dist.all_reduce(probe)
    if probe.tolist() != [3.0] * 4:
        raise AssertionError(f"gloo all-reduce of CUDA tensors: {probe}")

    # The unsharded references first (not counted).
    (means, values, covs, conics), samples, cfg, _ = headline(
        dev, 100_000, 1_000_000)
    ref_outs, _ = sampling.sample_binned(cfg, means, values, conics, covs,
                                         samples, SLICE_ORDERS)
    # Every rank runs one config, which covers both shards' binnings.
    cfg_sh = pm.plan_sharded_config(SamplerConfig(**HEADLINE), mesh, means,
                                    covs, samples)
    pcfg, field, gen, u_star, f_rhs = pigs_setup(dev)
    ((col, dx),) = pigs_draws(gen, dev, 1)
    ref_field = clone_field(field)
    ref_loss, _ = pigs.pigs_loss(pcfg, ref_field, col, dx, u_star(dx), f_rhs)
    ref_loss.backward()
    sampler, params, _ = agg_point(dev)
    sampler.preprocess_aggregate(method="pallas")
    ref_agg = agg_grads_of(sampler.aggregate_neighbors, params)
    step, shard_field = pm.make_model_sharded_pigs_step(pcfg, mesh, f_rhs,
                                                        u_star)
    shard = shard_field(field)
    opt = torch.optim.SGD(shard.parameters(), lr=PIGS_LR)

    reset_launches()
    outs, diag = pm.sharded_sample_all(cfg_sh, mesh, means, values, conics,
                                       covs, samples, SLICE_ORDERS)
    metrics = step(shard, opt, col, dx)
    _, _, agg = pm.build_sharded_aggregation(
        *agg_shard_inputs(sampler), 2, m)
    sh_agg = agg_grads_of(
        lambda *leaves: pm.sharded_aggregate(mesh, *leaves, agg), params)
    torch.cuda.synchronize()
    launches = expect_launches(
        "the sharded paths on two ranks", tiled_forward=3, tiled_backward=2,
        segment_sum=3, agg_totals=1, agg_forward=1, agg_backward=2,
        binning_keys=6)

    over = {k: int(diag[k]) for k in pigs.DIAGNOSTICS if int(diag[k])}
    over.update({f"pigs_{k}": int(metrics[k]) for k in pigs.DIAGNOSTICS
                 if int(metrics[k])})
    if over or int(agg.overflow):
        raise AssertionError(f"rank {m}: overflow {over}, aggregation "
                             f"{int(agg.overflow)}")
    errs = {f"eval_{o}": check_close(f"sharded_sample_all {o}", outs[o],
                                     ref_outs[o], RTOL)
            for o in SLICE_ORDERS}
    errs["pigs_loss"] = check_close("model-sharded PIGS loss",
                                    metrics["loss"], ref_loss.detach(), RTOL)
    scale = {}
    for name, p in shard.named_parameters():
        ref = pm.shard_rows(getattr(ref_field, name).grad, 2, m)
        errs[f"pigs_d{name}"] = check_close(
            f"model-sharded PIGS d{name}", p.grad, ref, GRAD_RTOL)
        scale[name] = float(p.grad.abs().sum() / ref.abs().sum())
    errs["agg_out"] = check_close("sharded_aggregate output", sh_agg[0],
                                  ref_agg[0], RTOL)
    for name, g, r in zip(AGG_GROUPS, sh_agg[1], ref_agg[1]):
        errs[f"agg_d{name}"] = check_close(
            f"sharded_aggregate d{name}", g, r, 3e-4, atol_rel=1e-4)

    n_eval = sum(o.numel() for o in outs.values())
    del ref_outs, outs
    buf = torch.zeros(n_eval, device=dev)
    times = {
        "sharded_eval": host_ms(lambda: pm.sharded_sample_all(
            cfg_sh, mesh, means, values, conics, covs, samples,
            SLICE_ORDERS), 3),
        "model_sharded_pigs_step": host_ms(
            lambda: step(shard, opt, col, dx), 3),
        "sharded_agg_step": host_ms(lambda: agg_grads_of(
            lambda *leaves: pm.sharded_aggregate(mesh, *leaves, agg),
            params), 3),
        "allreduce_eval_outputs": host_ms(
            lambda: dist.all_reduce(buf, group=mesh.get_group("model")), 3)}
    return {"rank": dist.get_rank(), "model": m, "launches": launches,
            "cfg": {"max_tiles_per_gaussian": cfg_sh.max_tiles_per_gaussian,
                    "entry_capacity_factor": cfg_sh.entry_capacity_factor,
                    "unwrapped_kernels": cfg_sh.unwrapped_kernels},
            "agg_range_entries": int((agg.ent_gid < AGG_P).sum()),
            "grad_scale_vs_unsharded": scale, "err": err_fields(errs),
            "ms_median": {k: statistics.median(v) for k, v in times.items()},
            "ms": times, "allreduce_floats": n_eval}


def phase_sharded_two_ranks(dev, timeout=900):
    """sharded_two_ranks: two processes on the one card, joined under gloo
    (NCCL takes one rank a device), mesh (1, 2): the headline evaluation,
    the model-sharded PIGS step's gradients and sharded_aggregate over two
    tile ranges, held against the unsharded paths on each rank (outputs
    rtol 2e-4, PIGS gradients 2e-3, aggregation gradients 3e-4 with atol
    1e-4 max|g|).  The kernel library is built in this process first; the
    ranks load it.  A rank that fails fails the phase."""
    _build.load()
    native._load()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            sharded_two_ranks_worker, args=(os.path.join(tmp, "store"), tmp),
            nprocs=2, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=5.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"sharded_two_ranks ran past "
                                       f"{timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    launches = {name: sum(r["launches"][name] for r in ranks)
                for name in KERNELS}
    emit("sharded_two_ranks", backend="gloo", mesh=[1, 2],
         gloo_takes_cuda_tensors=True, launches=launches, ranks=ranks)
    return launches


def sharded_times(dev):
    """--sharded: the two sharded phases alone."""
    phase_sharded(dev)
    phase_sharded_two_ranks(dev)


# Each tool run: (key in launches_by_path, tool module name, settings
# environment, kernels its path launches, kernels its profile must name).
TILED = ("tiled_forward", "tiled_backward", "segment_sum")
AGG = ("agg_forward", "agg_backward", "segment_sum")
KEYS = ("binning_keys",)
ALL_PROF = {"PROF_TOP": "100000"}
TOOL_RUNS = (
    ("tool_bench_d2", "bench", {}, TILED + KEYS, ()),
    ("tool_bench_d3", "bench", {"BENCH_D": "3"}, TILED + KEYS, ()),
    # bench.py's all-pairs method at dense config 2's width.
    ("tool_bench_pallas", "bench",
     {"BENCH_METHOD": "pallas", "BENCH_D": "3", "BENCH_P": "10000",
      "BENCH_N": "100000", "BENCH_ORDERS": ",".join(ORDERS)},
     ("dense_forward", "dense_backward"), ()),
    ("tool_profile_step_d2", "profile_step", ALL_PROF, TILED + KEYS,
     TILED),
    ("tool_profile_step_d3", "profile_step",
     {"BENCH_D": "3", "BENCH_METHOD": "chunked", "BENCH_TILE": "0.2",
      "BENCH_ELLIP": "1", **ALL_PROF}, TILED + KEYS, TILED),
    ("tool_profile_bench", "profile_bench", {}, TILED + KEYS, ()),
    ("tool_train_100k", "train_100k", {},
     TILED + AGG + ("agg_totals",) + KEYS, ()),
    ("tool_bench_aggregate", "bench_aggregate", {},
     AGG + ("agg_totals",) + KEYS, ()),
    ("tool_profile_aggregate", "profile_aggregate", ALL_PROF,
     AGG + ("agg_totals",) + KEYS, AGG),
    ("tool_profile_dynamics_rollout", "profile_dynamics",
     {"DYN_PROFILE": "rollout", **ALL_PROF},
     TILED + AGG + ("agg_totals",) + KEYS, AGG),
    ("tool_profile_dynamics_eval", "profile_dynamics",
     {"DYN_PROFILE": "eval", **ALL_PROF},
     TILED + AGG + ("agg_totals",) + KEYS, TILED),
    ("tool_sweep_tile", "sweep_tile", {"SWEEP_STEPS": "3"}, TILED + KEYS,
     ()),
    ("tool_sweep_chunked", "sweep_chunked", {"SWEEP_STEPS": "3"},
     TILED + KEYS, ()),
)


def phase_tools(dev):
    """The measuring tools at their full-width defaults, each through its
    run(settings) as ``python -m dgs_tpu_torch.tools.<name>`` runs it (the
    settings from the environment given here, not this process's).
    Returns the launches by run."""
    import importlib

    name = torch.cuda.get_device_name(dev)
    launches, seconds = {}, {}
    t_phase = time.perf_counter()
    for key, tool, env, kernels, named in TOOL_RUNS:
        mod = importlib.import_module(f"dgs_tpu_torch.tools.{tool}")
        reset_launches()
        t0 = time.perf_counter()
        records = mod.run(mod.settings(env))
        torch.cuda.synchronize()
        seconds[key] = time.perf_counter() - t0
        launches[key] = read_launches()
        for r in records:
            emit("tools", run=key, **r)
        if tool == "train_100k":
            mod.check(records)
        missing = [k for k in kernels if launches[key][k] < 1]
        if missing:
            raise AssertionError(f"{key} launched none of {missing}")
        for r in records:
            if r["device"] != name or not r["power_limit"]:
                raise AssertionError(f"{key}: record without the card: {r}")
            if "skip" in r:
                raise AssertionError(f"{key} skipped a tile: {r}")
            for k, v in r.get("detail", r).items():
                if "overflow" in k and (any(v.values()) if isinstance(
                        v, dict) else v):
                    raise AssertionError(f"{key}: {k} = {v}")
        if named:
            ops = [r["name"] for r in records if "name" in r]
            if not ops or not any("scope" in r for r in records):
                raise AssertionError(f"{key}: the profile is empty")
            absent = [k for k in named
                      if not any(f"{k}_" in op for op in ops)]
            if absent:
                raise AssertionError(f"{key}: {absent} not in its profile")
    emit("tools_summary", seconds=time.perf_counter() - t_phase,
         seconds_by_run=seconds)
    return launches


# ------------------------------------------------------------ kernel modes

# The JAX suite's tolerance for the moment-form backward against the
# per-pair one (test_binning_tiled.py:386-410: rtol 2e-3, atol 2e-4 max|ref|):
# two algorithms.  moment_combine forms the gradients from differences of
# moments summed over every sample in an entry's tile, so the error grows
# with the samples a tile: up to 7.8e-5 of max|ref| at D = 1 here (3,125
# samples a tile) and 4.8e-5 on the D = 2 headline (about 625), where the
# general atol of 1e-5 fails; a forward of one TF32 pass moves the
# gradients by more than this limit (the control in phase_modes_slice).
MOMENT_ATOL_REL = 2e-4
ONE_PASS_SANITY = 2e-2   # max|err| / max|ref| of the 1-pass forward against
                         # the 3-pass one: a sanity bound, not a tolerance
FIELD_PARAMS = ("means", "log_scales", "rotations", "values")
MODE_RUNS = (("classic", {}), ("fastmath", {"BENCH_FASTMATH": "1"}),
             ("sep_moments", {"BENCH_SEP": "1", "BENCH_MOMENTS": "1"}))


def wrap_free_case(dev, seed, D, sigma, C, holes=False, open_domain=False):
    """small_field's field binned wrap-free (the modes need tile-local
    operands): unwrapped under the planner's certificate on the periodic
    domain, or on the open box [-1, 1]^D for footprints wider than the
    certificate allows.  Returns ((means, values, covs, conics), samples,
    generator, cfg, state)."""
    (means, values, covs, conics), samples, g = small_field(
        dev, seed, D, sigma, C, holes)
    kw = dict(tile_size=0.1275, eig_floor=1e-12)
    if open_domain:
        kw.update(period=None, lower=(-1.0,) * D, upper_bounds=(1.0,) * D)
    cfg, plan = planned_config(SamplerConfig(**kw).with_dims(D), means,
                               covs, samples)
    if not open_domain:
        if not plan["safe_unwrapped"]:
            raise AssertionError(f"D={D}: planner does not certify the "
                                 "unwrapped kernels for this case")
        cfg = dataclasses.replace(cfg, unwrapped_kernels=True)
    state = binning.build(cfg, means, covs, samples)
    assert int(state.overflow) == 0 and int(state.entry_overflow) == 0
    return (means, values, covs, conics), samples, g, cfg, state


def mode_case(dev, seed, D, sigma, C, holes=False, open_domain=False):
    """wrap_free_case's case in the separable layout: (state, geom, mono,
    P, N, generator)."""
    (means, values, _, conics), samples, g, cfg, state = wrap_free_case(
        dev, seed, D, sigma, C, holes, open_domain)
    geom = ktiled.prepare_entries(state, means, values, conics,
                                  ktiled.BLOCK_E, cfg=cfg, separable=True)[2]
    mono = ktiled.prepare_samples(state, samples, ktiled.BLOCK_N, cfg=cfg,
                                  separable=True)[0]
    return state, geom, mono, means.shape[0], samples.shape[0], g


def one_pass_error(one, three, orders, D, C):
    """max|1 pass - 3 passes| / max|3 passes| per order and over all."""
    out, k0 = {}, 0
    for order in orders:
        rows = slice(k0 * C, (k0 + formulas.n_unique(order, D)) * C)
        out[order] = float((one[rows] - three[rows]).abs().max()) / max(
            float(three[rows].abs().max()), 1e-30)
        k0 += formulas.n_unique(order, D)
    out["all"] = float((one - three).abs().max()) / max(
        float(three.abs().max()), 1e-30)
    return out


def moment_errs(got, ref, orders, D):
    n_rows = ktiled.moment_layout(orders, D)[3]
    return {"moments": check_close(
        "moment backward against the plain version on the moment rows",
        got[:n_rows], ref[:n_rows], GRAD_RTOL),
        "values": check_close(
        "moment backward against the plain version on the value rows",
        got[n_rows:], ref[n_rows:], GRAD_RTOL)}


def phase_parity_modes(dev):
    """The two mode kernels against their plain versions on the same
    operands (3 passes within the fp32 gate; the 1-pass separable forward,
    outside the gate, against the 3-pass one under ONE_PASS_SANITY), the
    moment rows folded by moment_combine against the classic backward on
    the same tile-local operands, dead columns exactly zero, two runs of
    the backward and of the forward bitwise equal; each case reports the
    moment form's and the separable forward's instantiations (moment_facts,
    sep_facts at 3 and 1 passes) and its 32-entry ranges, blocks of entry
    ranges and blocks of sample ranges (the separable forward's) that
    straddle two tiles, and the phase fails unless some do;
    then the op's outputs and gradients in each mode against the dense
    masked oracle (gradients twice, bitwise equal), with the kernels each
    mode launched."""
    t_phase = time.perf_counter()
    cases = [(D, 0.03, C, False, False) for D in (1, 2, 3) for C in (1, 4, 6)]
    cases += [(2, 0.6, 4, False, True),     # full-cover footprints, open box
              (2, 0.03, 4, True, False)]    # tiles without samples / entries
    worst = 0.0
    straddling = {"range_32": 0, "block": 0, "sep_block": 0}
    for i, (D, sigma, C, holes, open_domain) in enumerate(cases):
        state, geom, mono, P, N, g = mode_case(dev, 80 + i, D, sigma, C,
                                               holes, open_domain)
        lo, n = ktiled.entry_ranges(state, mono.shape[1])
        got = ktiled.tiled_forward_sep(ORDERS, D, C, geom, mono, lo, n,
                                       passes=3)
        one = ktiled.tiled_forward_sep(ORDERS, D, C, geom, mono, lo, n,
                                       passes=1)
        ref = ktiled.tiled_forward_sep_plain(ORDERS, D, C, geom, mono, lo, n)
        again = ktiled.tiled_forward_sep(ORDERS, D, C, geom, mono, lo, n,
                                         passes=3)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"separable forward D={D} C={C}: two runs "
                                 "differ")
        errs = compare(got, ref, ORDERS, D, C)
        pads = check_dead_rows("separable forward", got, mono[-1] < 0)
        check_dead_rows("separable forward, 1 pass", one, mono[-1] < 0)
        one_err = one_pass_error(one, got, ORDERS, D, C)
        worst = max(worst, one_err["all"])
        if one_err["all"] > ONE_PASS_SANITY:
            raise AssertionError(f"1-pass separable forward D={D} C={C}: "
                                 f"{one_err} above {ONE_PASS_SANITY}")
        s_lo, s_n = ktiled.sample_ranges(state, geom.shape[1])
        bwd = {}
        # Partial order sets (no W rows; the PIGS collocation set) at D = 2.
        for orders in ((ORDERS, ("value",), ("laplacian", "value"))
                       if D == 2 and not holes and not open_domain
                       else (ORDERS,)):
            K = ktiled.total_unique(orders, D)
            ct = torch.randn((K * C, mono.shape[1]), generator=g, device=dev)
            rows = ktiled.tiled_backward_moments(orders, D, C, geom, mono,
                                                 ct, s_lo, s_n)
            again = ktiled.tiled_backward_moments(orders, D, C, geom, mono,
                                                  ct, s_lo, s_n)
            ref_rows = ktiled.tiled_backward_moments_plain(
                orders, D, C, geom, mono, ct, s_lo, s_n)
            classic = ktiled.tiled_backward(
                orders, None, D, C, ktiled.base_rows(geom, D, C),
                ktiled.local_samples(mono, D), ct, s_lo, s_n)
            torch.cuda.synchronize()
            dead = check_dead_rows("moment backward", rows,
                                   dead_entries(geom, state))
            if not torch.equal(rows, again):
                raise AssertionError(f"moment backward D={D} C={C}: two "
                                     "runs differ")
            bwd[",".join(orders)] = {
                "err": err_fields(moment_errs(rows, ref_rows, orders, D)),
                "combined_vs_classic_err": err_fields(compare_rows(
                    ktiled.moment_combine(orders, D, C, rows, geom),
                    classic, D, C, atol_rel=MOMENT_ATOL_REL)),
                "sentinel_columns_zero": dead}
        T = state.ent_start.shape[0] - 2
        blocks = {"range_32": straddling_blocks(state.ent_tile[0], T,
                                                ktiled.BLOCK_E),
                  "block": straddling_blocks(
                      state.ent_tile[0], T,
                      _build.load().dgs_tiled_backward_moments_block(D)),
                  "sep_block": straddling_blocks(
                      state.s_tile[0], T,
                      _build.load().dgs_tiled_forward_sep_block())}
        for key, count in blocks.items():
            straddling[key] += count
        emit("parity_modes", D=D, sigma=sigma, C=C, P=P, N=N, holes=holes,
             open_domain=open_domain, straddling_blocks=blocks,
             instantiation=moment_facts(ORDERS, D, C),
             sep_instantiations={p: sep_facts(ORDERS, D, C, p)
                                 for p in (3, 1)},
             entries=int((~dead_entries(geom, state)).sum()),
             pad_columns_zero=pads, **tile_facts(state),
             separable_err=err_fields(errs),
             one_pass_vs_three_pass=one_err,
             one_pass_label="outside the fp32 gate", backward=bwd)

    for D in (1, 2, 3):
        gen = torch.Generator(device=dev).manual_seed(50 + D)
        field = init_field(gen, 300, D, 3, sigma=0.05)
        samples = 2.0 * torch.rand((2000, D), generator=gen, device=dev) - 1.0
        with torch.no_grad():
            m, v = field.means.detach(), field.values.detach()
            cov, con = field.covariances(), field.conics()
        cfg, plan = planned_config(
            SamplerConfig(tile_size=0.25).with_dims(D), m, cov, samples)
        if not plan["safe_unwrapped"]:
            raise AssertionError(f"D={D}: no wrap-free certificate")
        state = binning.build(cfg, m, cov, samples)
        mask = binning.pair_mask_dense(cfg, state, samples, 300)

        def loss_oracle(m_, v_, c_):
            return sum((oracle.evaluate(o, m_, v_, c_, samples,
                                        period=cfg.period,
                                        pair_mask=mask) ** 2).sum()
                       for o in ORDERS)

        def grads(loss):
            args = [a.clone().requires_grad_() for a in (m, v, con)]
            return torch.autograd.grad(loss(*args), args)

        ref = grads(loss_oracle)
        refs = [oracle.evaluate(o, m, v, con, samples, period=cfg.period,
                                pair_mask=mask) for o in ORDERS]
        for sep, mom in ((True, False), (False, True), (True, True)):
            def loss_modes(m_, v_, c_, sep=sep, mom=mom):
                outs = sampling.sample_tiled_multi(
                    ORDERS, cfg, m_, v_, c_, samples, state, unwrapped=True,
                    separable=sep, moments=mom)
                return sum((o ** 2).sum() for o in outs)

            reset_launches()
            got = grads(loss_modes)
            launched = expect_launches(
                f"D={D} separable={sep} moments={mom}",
                **{"tiled_forward_sep" if sep else "tiled_forward": 1,
                   "tiled_backward_moments" if mom else "tiled_backward": 1,
                   "segment_sum": 1})
            again = grads(loss_modes)
            outs = sampling.sample_tiled_multi(
                ORDERS, cfg, m, v, con, samples, state, unwrapped=True,
                separable=sep, moments=mom)
            err = {o: check_close(f"modes vs oracle D={D} {o}", a, r,
                                  RTOL)[0]
                   for o, a, r in zip(ORDERS, outs, refs)}
            for name, a, b, r in zip(("means", "values", "conics"), got,
                                     again, ref):
                if not torch.equal(a, b):
                    raise AssertionError(f"modes D={D} d{name}: two runs "
                                         "differ")
                err[f"d{name}"] = check_close(
                    f"mode grads vs oracle D={D} d{name}", a, r,
                    GRAD_RTOL)[0]
            emit("parity_modes_oracle", D=D, P=300, N=2000, separable=sep,
                 moments=mom, launches=launched, max_abs_err=err,
                 bitwise_repeatable=True)
    if not all(straddling.values()):
        raise AssertionError(f"no range straddles two tiles: {straddling}")
    emit("parity_modes_summary", one_pass_worst=worst,
         straddling_blocks=straddling, seconds=time.perf_counter() - t_phase)
    return worst


def modes_workload(dev, env, D=3):
    """tools.bench's workload for settings from ``env`` (BENCH_D=D on the
    card, the bench defaults otherwise): (settings, planned workload)."""
    s = bench.settings({"BENCH_D": str(D), **env})
    field, samples = bench.field_and_samples(s["P"], s["N"], s["D"], s["C"],
                                             s["sigma"], dev)
    return s, bench.plan(bench.config(s), s["method"], field, samples,
                         s["orders"])


def loss_and_grads(w):
    """bench.loss of the workload and its gradients to the field's
    parameters (no step taken)."""
    params = list(w.field.parameters())
    value, diag = bench.loss(w)
    grads = torch.autograd.grad(value, params)
    diag = {k: int(x) for k, x in diag.items()}
    if any(diag.values()):
        raise AssertionError(f"diagnostics not zero: {diag}")
    return float(value), [g.detach() for g in grads], diag


def mode_step(dev, name, w, expect, steps=10):
    """One workload's training step (tools.bench.train_step) timed on the
    synchronised host clock (median and range of ``steps`` warm steps),
    the launches of those steps (counts set to 0 just before, read just
    after), device busy ms, peak bytes, bitwise-repeatable gradients, and
    the workload's evaluation operands for the kernels' times."""
    t0 = time.perf_counter()
    loss, grads, diag = loss_and_grads(w)
    again = loss_and_grads(w)[1]
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        raise AssertionError(f"{name}: gradients differ between two runs")
    value, _ = bench.loss(w)
    (ev,) = tiled_evaluations(value)
    del value
    step = bench.train_step(w)
    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times = host_ms(step, steps)
    launches = read_launches()
    # The modes the step ran, read from the kernels it launched: ``expect``
    # is (separable, moments) or {kernel: launched or not}.
    if isinstance(expect, dict):
        ran = expect
    else:
        sep, mom = expect
        ran = {"tiled_forward_sep": sep, "tiled_forward": not sep,
               "tiled_backward_moments": mom, "tiled_backward": not mom}
    if any(bool(launches[k]) != on for k, on in ran.items()):
        raise AssertionError(f"{name}: launched {launches}, expected "
                             f"{ran}")
    peak = torch.cuda.max_memory_allocated()
    t1 = time.perf_counter()
    busy, top, items = device_busy(step, 5)
    fields = dict(
        seconds={"steps": t1 - t0, "profile": time.perf_counter() - t1},
        run=name, expect=ran,
        passes=ktiled.dot_passes(w.cfg), D=w.samples.shape[1],
        P=w.field.P, N=w.samples.shape[0], method=w.method,
        orders=list(w.orders), tile=w.cfg.tile_size,
        unwrapped_kernels=w.cfg.unwrapped_kernels, diagnostics=diag,
        loss=loss, step_ms_median=statistics.median(times),
        step_ms_min=min(times), step_ms_max=max(times), step_ms=times,
        steps=steps, launches=launches,
        launches_per_step={k: v / (steps + 1) for k, v in launches.items()},
        device_busy_ms_per_step=busy, device_items_per_step=items,
        idle_share=max(0.0, 1.0 - busy / statistics.median(times)),
        top=top, peak_bytes=peak, grads_bitwise_repeatable=True)
    return fields, grads, ev, launches


def mode_kernel_numbers(ev, sides, plain=True):
    """The kernels of one evaluation's operands (from tiled_evaluations) on
    the step's own cotangent (d loss / d packed outputs): CUDA-event ms
    (median of 10), the bound, and for the mode kernels the plain version's
    ms and the kernel's max abs error against it.  ``sides`` names the
    kernels to time: the classic pair or the mode pair."""
    orders, D, C = ev["orders"], ev["D"], ev["C"]
    geom, smp, state = ev["geom"], ev["smp"], ev["state"]
    N = state.s_perm.shape[0]
    lo, n = ktiled.entry_ranges(state, smp.shape[1])
    s_lo, s_n = ktiled.sample_ranges(state, geom.shape[1])
    pairs = pair_counts(state)[0]
    w = torch.cat([torch.tensor(formulas.sym_multiplicity(o, D),
                                dtype=torch.float32, device=geom.device
                                ).repeat_interleave(C) for o in orders])
    with torch.no_grad():
        if ev["folded"]:
            packed = ktiled.tiled_forward_folded(
                orders, D, C, geom, ev["fold"], smp, lo, n,
                passes=ev["passes"])
        elif ev["separable"]:
            packed = ktiled.tiled_forward_sep(orders, D, C, geom, smp, lo, n,
                                              passes=ev["passes"])
        elif ev["moments"]:
            packed = ktiled.tiled_forward(
                orders, None, D, C, ktiled.base_rows(geom, D, C),
                ktiled.local_samples(smp, D), lo, n)
        else:
            packed = ktiled.tiled_forward(orders, ev["period"], D, C, geom,
                                          smp, lo, n)
        ct = (2.0 / N) * w[:, None] * packed
    cb = local = None
    if ev["folded"]:
        meta = formulas.folded_structure(orders, D)[0]
        cb = ktiled.ct_beta_rows(meta, C, ct, smp)
        local = ktiled.local_samples(smp, D)
    out = {}
    for kernel in sides:
        # Floats moved: each input the kernel reads once, its output once.
        Ep = geom.shape[1]
        base = 1 + D + D * (D + 1) // 2 + C
        if kernel == "tiled_forward":
            call = lambda: ktiled.tiled_forward(orders, ev["period"], D, C,
                                                geom, smp, lo, n)
            floats = sum(t.numel() for t in (geom, smp, lo, n, packed))
        elif kernel == "tiled_backward":
            call = lambda: ktiled.tiled_backward(orders, ev["period"], D, C,
                                                 geom, smp, ct, s_lo, s_n)
            floats = sum(t.numel() for t in (geom, smp, ct, s_lo, s_n)) + \
                (base - 1) * Ep
        elif kernel == "tiled_forward_sep":
            call = lambda: ktiled.tiled_forward_sep(
                orders, D, C, geom, smp, lo, n, passes=ev["passes"])
            plain_call = lambda: ktiled.tiled_forward_sep_plain(
                orders, D, C, geom, smp, lo, n)
            floats = sum(t.numel() for t in (geom, smp, lo, n, packed))
        elif kernel in FOLDED_KERNELS:
            call, plain_call, floats = folded_calls(kernel, ev, lo, n, s_lo,
                                                    s_n, ct, cb, local,
                                                    packed)
        else:
            call = lambda: ktiled.tiled_backward_moments(
                orders, D, C, geom, smp, ct, s_lo, s_n)
            plain_call = lambda: ktiled.tiled_backward_moments_plain(
                orders, D, C, geom, smp, ct, s_lo, s_n)
            n_rows = ktiled.moment_layout(orders, D)[3]
            floats = base * Ep + sum(t.numel() for t in (
                smp, ct, s_lo, s_n)) + (n_rows + C) * Ep
        ms = cuda_ms(call)
        if kernel in FOLDED_KERNELS and not plain:
            got = call()
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{kernel}: not finite at full width")
            del got
        if kernel in ("tiled_forward", "tiled_backward"):
            bound = kernel_bound(pairs, floats, D, orders, C,
                                 ev["period"] is not None,
                                 kernel == "tiled_backward")
        elif kernel in FOLDED_KERNELS:
            bound = mode_bound(pairs, floats, D, orders, C,
                               FOLDED_KERNELS[kernel], ev["passes"])
        else:
            kind = ("separable" if kernel == "tiled_forward_sep"
                    else "moments")
            bound = mode_bound(pairs, floats, D, orders, C, kind,
                               ev["passes"] if kind == "separable" else 3)
        out[kernel] = {"ms": ms, **bound, "share": bound["bound_ms"] / ms,
                       "kept_pairs": pairs}
        if kernel in FOLDED_KERNELS:
            out[kernel]["instantiation"] = (
                hmm_facts(orders, D, C, ev["period"] is not None)
                if kernel == "tiled_backward_hmm"
                else folded_facts(kernel, orders, D, C))
            # One TF32 pass: a third of the contraction, the rest the same.
            passes, ev["passes"] = ev["passes"], 1
            out[kernel]["ms_one_pass"] = cuda_ms(folded_calls(
                kernel, ev, lo, n, s_lo, s_n, ct, cb, local, packed)[0])
            ev["passes"] = passes
        elif kernel == "tiled_backward_moments":
            out[kernel]["instantiation"] = moment_facts(orders, D, C)
        elif kernel == "tiled_forward_sep":
            out[kernel]["instantiation"] = sep_facts(orders, D, C,
                                                     ev["passes"])
        elif kernel in ("tiled_forward", "tiled_backward"):
            out[kernel]["instantiation"] = instantiation(
                kernel, orders, D, C, ev["period"])
        if kernel in FOLDED_KERNELS and plain:
            got = call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = plain_call()
            torch.cuda.synchronize()
            out[kernel]["plain_ms"] = 1e3 * (time.perf_counter() - t0)
            ref64 = (plain_call(torch.float64)
                     if kernel != "tiled_backward_hmm" else None)
            err = folded_check(f"{kernel} at full width", got, ref, ref64,
                               fwd_groups(orders, D, C)
                               if kernel == "tiled_forward_folded"
                               else bwd_groups(D, C))
            out[kernel]["max_abs_err"] = err["max_abs"]
            out[kernel]["err"] = err
            del got, ref, ref64
        if kernel in ("tiled_forward_sep", "tiled_backward_moments") and \
                plain:
            got = call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = plain_call()
            torch.cuda.synchronize()
            out[kernel]["plain_ms"] = 1e3 * (time.perf_counter() - t0)
            if kernel == "tiled_forward_sep":
                errs = compare(got, ref, orders, D, C)
            else:
                errs = moment_errs(got, ref, orders, D)
            out[kernel]["max_abs_err"] = max(e[0] for e in errs.values())
            out[kernel]["err"] = err_fields(errs)
            del got, ref
    return out


def grads_close(what, got, ref):
    """A mode step's gradients against the classic step's: the moment-form
    backward against the per-pair one, at the JAX suite's tolerance for
    that comparison (MOMENT_ATOL_REL)."""
    return {name: check_close(f"{what} d{name}", a, b, GRAD_RTOL,
                              MOMENT_ATOL_REL)
            for name, a, b in zip(FIELD_PARAMS, got, ref)}


def phase_modes_slice(dev, steps=10):
    """The kernel modes on their path at full width: the D = 3 chunked
    bench step (tools.bench at BENCH_D=3: 100k x 1M, tile 0.2, axis radii,
    ellipsoid cull, three orders) in the classic kernels, (a) under
    BENCH_FASTMATH=1 (the automatic default turns both modes on, the
    separable contraction at 1 pass) and (b) under BENCH_SEP=1
    BENCH_MOMENTS=1 (3 passes, inside the fp32 gate): steps, launches,
    busy ms, peak bytes; each kernel's CUDA-event time on its step's own
    operands beside classic kernels 1-2; (b) against the classic step's
    loss and gradients within the gate, (a)'s difference reported.  Then
    the D = 2 headline step with BENCH_SEP=1 BENCH_MOMENTS=1 against the
    classic D = 2 step.  Returns (launches by path, kernel numbers)."""
    runs, launches, kernels = {}, {}, {}
    t_phase = time.perf_counter()
    for name, env in MODE_RUNS:
        t0 = time.perf_counter()
        s, w = modes_workload(dev, env)
        t_plan = time.perf_counter() - t0
        expect = (False, False) if name == "classic" else (True, True)
        fields, grads, ev, launched = mode_step(dev, name, w, expect, steps)
        sides = (("tiled_forward", "tiled_backward") if name == "classic"
                 else ("tiled_forward_sep", "tiled_backward_moments"))
        t0 = time.perf_counter()
        k = mode_kernel_numbers(ev, sides, plain=name == "sep_moments")
        fields["seconds"].update(plan=t_plan,
                                 kernels=time.perf_counter() - t0)
        if name == "fastmath":
            # The 1-pass forward against the 3-pass one on (a)'s operands.
            lo, n = ktiled.entry_ranges(ev["state"], ev["smp"].shape[1])
            one = ktiled.tiled_forward_sep(ev["orders"], 3, ev["C"],
                                           ev["geom"], ev["smp"], lo, n, 1)
            ref = ktiled.tiled_forward_sep(ev["orders"], 3, ev["C"],
                                           ev["geom"], ev["smp"], lo, n, 3)
            fields["one_pass_vs_three_pass"] = one_pass_error(
                one, ref, ev["orders"], 3, ev["C"])
            del one, ref
        runs[name] = (fields, grads)
        launches[f"modes_{name}"] = launched
        fields["kernels"] = k
        kernels[name] = k
        del ev, w
        torch.cuda.empty_cache()
        if name == "classic":
            emit("modes_slice", **fields)
    base_loss, base_grads = runs["classic"][0]["loss"], runs["classic"][1]
    for name in ("fastmath", "sep_moments"):
        fields, grads = runs[name]
        rel = abs(fields["loss"] - base_loss) / abs(base_loss)
        if name == "sep_moments":
            check_close("sep+moments loss vs classic",
                        torch.tensor([fields["loss"]]),
                        torch.tensor([base_loss]), RTOL)
            fields["vs_classic"] = {"loss_rel": rel, **err_fields(
                grads_close("sep+moments vs classic", grads, base_grads))}
        else:
            fields["vs_classic"] = {"loss_rel": rel, **{
                n_: {"max_abs": float((a - b).abs().max()), "rel": float(
                    (a - b).abs().max() / b.abs().max())}
                for n_, a, b in zip(FIELD_PARAMS, grads, base_grads)},
                "label": "outside the fp32 gate"}
            # Control: the gate that (b) passes must see a 1-pass forward.
            worst = max(fields["vs_classic"][n_]["rel"]
                        for n_ in FIELD_PARAMS)
            if worst <= MOMENT_ATOL_REL:
                raise AssertionError(
                    f"fast-math gradients within {worst} of max|ref| of the "
                    f"classic step's: MOMENT_ATOL_REL {MOMENT_ATOL_REL} "
                    "would not tell a 1-pass forward from 3 passes")
            fields["vs_classic"]["exceeds_moment_atol"] = worst
        emit("modes_slice", **fields)

    # The D = 2 headline step in both modes (its D = 2 instantiations).
    _, w2c = modes_workload(dev, {}, D=2)
    loss2, grads2, _ = loss_and_grads(w2c)
    del w2c
    _, w2 = modes_workload(dev, {"BENCH_SEP": "1", "BENCH_MOMENTS": "1"},
                           D=2)
    fields, grads, ev, launched = mode_step(dev, "d2_sep_moments", w2,
                                            (True, True), steps)
    k2 = mode_kernel_numbers(ev, ("tiled_forward_sep",
                                  "tiled_backward_moments"), plain=False)
    check_close("D=2 sep+moments loss vs classic",
                torch.tensor([fields["loss"]]), torch.tensor([loss2]), RTOL)
    fields["vs_classic"] = {"loss_rel": abs(fields["loss"] - loss2) / abs(
        loss2), **err_fields(grads_close("D=2 sep+moments vs classic",
                                         grads, grads2))}
    fields["kernels"] = k2
    launches["modes_d2_sep_moments"] = launched
    fields["phase_seconds"] = time.perf_counter() - t_phase
    emit("modes_slice", **fields)
    del ev, w2
    torch.cuda.empty_cache()
    return launches, kernels


def modes_times(dev):
    """python3 chip_smoke.py --modes: the two mode phases alone."""
    worst = phase_parity_modes(dev)
    launches, kernels = phase_modes_slice(dev)
    emit("modes_summary", one_pass_worst=worst, launches=launches,
         kernels=kernels)


# ---------------------------------------------------------------- folded

# A folded op or step against the classic one: two algorithms, held to the
# JAX suite's limit for exactly this comparison (tests/test_binning_tiled.py
# :441-446, rtol 2e-3 / atol 2e-4 max(1, |ref|)).
FOLD_ATOL_REL = 2e-4
# The folded kernels against their plain versions, where the general
# limits fail: the expanded polynomials cancel, so the fp32
# plain version itself misses a float64 evaluation of the same operands by
# up to ~7e-5 of max|ref| (CPU, D = 3, tile 0.1275), and 3 TF32 passes keep
# ~21 bits a product against fp32's 24 (8x).  Then the kernel's error
# against the float64 evaluation may be at most this many times the plain
# version's (plus the general atol): 4 bits lost, no more.
FOLD_ERR_RATIO = 16.0
PARTIAL = ("value", "laplacian")
THREE = ("value", "derivative", "laplacian")
# Kernel wrapper -> roofline.mode_bound kind.
FOLDED_KERNELS = {"tiled_forward_folded": "folded",
                  "tiled_backward_fdv": "folded_dvals",
                  "tiled_backward_fvjp": "folded_vjp",
                  "tiled_backward_hmm": "h_matmul"}
# folded_slice's runs: (name, bench knobs, the kernels the step launches).
FOLDED_RUNS = (
    ("folded", {"BENCH_FOLDED": "1"},
     {"tiled_forward_folded": True, "tiled_backward": True}),
    ("folded_dvals", {"BENCH_FOLDED": "1", "BENCH_FDV": "1"},
     {"tiled_forward_folded": True, "tiled_backward_fdv": True,
      "tiled_backward": False}),
    ("folded_vjp", {"BENCH_FOLDED": "1", "BENCH_FDV": "1",
                    "BENCH_FVJP": "1"},
     {"tiled_forward_folded": True, "tiled_backward_fvjp": True,
      "tiled_backward": False}),
    ("h_matmul", {"BENCH_HMM": "1"},
     {"tiled_forward": True, "tiled_backward_hmm": True,
      "tiled_backward": False}),
)
FOLDED_FLAGS = {"BENCH_FOLDED": "folded_values", "BENCH_FDV": "folded_dvals",
                "BENCH_FVJP": "folded_vjp", "BENCH_HMM": "h_matmul"}


def folded_check(what, got, ref, ref64, groups):
    """A folded kernel against its plain version, per row group (``groups``
    {name: row slice}): within the general limits (RTOL for the forward's
    orders, GRAD_RTOL for the backward's rows; ATOL_REL) or, where
    ``ref64`` (the plain version on float64 operands) is given, the
    kernel's max error against it at most FOLD_ERR_RATIO times the plain
    version's plus ATOL_REL, in units of max(1, max|ref|) of the group;
    raises otherwise.  Returns the readings and the largest abs error."""
    out, worst = {}, 0.0
    for name, (rows, rtol) in groups.items():
        g, r = got[rows], ref[rows]
        if r.numel() == 0:
            continue
        scale = max(1.0, float(r.abs().max()))
        diff = (g - r).abs()
        within = not bool((diff > ATOL_REL * scale + rtol * r.abs()).any())
        e = {"max_abs": float(diff.max()), "rel": float(diff.max()) / scale,
             "within_general": within}
        worst = max(worst, e["max_abs"])
        if ref64 is not None:
            e["kernel_vs_f64"] = float((g - ref64[rows]).abs().max()) / scale
            e["plain_vs_f64"] = float((r - ref64[rows]).abs().max()) / scale
            within = within or (e["kernel_vs_f64"] <= FOLD_ERR_RATIO
                                * e["plain_vs_f64"] + ATOL_REL)
        if not within:
            raise AssertionError(f"{what} {name}: {e}")
        out[name] = e
    out["max_abs"] = worst
    return out


def fwd_groups(orders, D, C):
    groups, k0 = {}, 0
    for order in orders:
        nu = formulas.n_unique(order, D)
        groups[order] = (slice(k0 * C, (k0 + nu) * C), RTOL)
        k0 += nu
    return groups


def bwd_groups(D, C):
    tri = D * (D + 1) // 2
    return {"means": (slice(0, D), GRAD_RTOL),
            "conics": (slice(D, D + tri), GRAD_RTOL),
            "values": (slice(D + tri, D + tri + C), GRAD_RTOL),
            "vz": (slice(D + tri + C, None), GRAD_RTOL)}


def folded_facts(kernel, orders, D, C):
    """The build and launch facts of the redesigned folded forward, folded
    dvalues or VJP at (orders, D, C): registers, spill bytes and static
    shared bytes of its instantiation (the ptxas report), the dynamic shared
    bytes of a launch, the blocks an SM holds, and the passes over the pairs
    (the forward's passes of 128 or 384 rows; the folded dvalues' passes of
    up to 384 Zd rows; the VJP's Zd windows).  The folded dvalues' facts are
    those of its instantiation without h_matmul."""
    lib = _build.load()
    meta, n_mono, R, Rp = ktiled.folded_layout(orders, D, C)
    threads = 256
    if kernel == "tiled_backward_fdv":
        mask = ktiled._order_rows(orders, D)[0]
        dyn = lib.dgs_tiled_backward_fdv_smem(D, mask, Rp, C, 0)
        rows = lib.dgs_tiled_backward_fdv_pass_rows(D, mask, Rp, C, 0)
        warps = lib.dgs_tiled_backward_fdv_warps(Rp, 0)
        threads = 32 * warps
        name = f"{kernel}_kernelILi{D}ELi{mask}ELb0ELi{warps}EE"
    elif kernel == "tiled_forward_folded":
        dyn = lib.dgs_tiled_forward_folded_smem(
            D, Rp, n_mono, ktiled.total_unique(orders, D) * C)
        rows = lib.dgs_tiled_forward_folded_pass_rows(Rp)
        # its template: D, then the m16 tiles of Z a warp holds
        name = f"{kernel}_kernelILi{D}ELi{rows // 128}EE"
    else:
        nsel = len(ktiled.fvjp_vz_groups(orders, D))
        dyn = lib.dgs_tiled_backward_fvjp_smem(D, Rp, C, nsel)
        rows = lib.dgs_tiled_backward_fvjp_window(D, Rp, C, nsel)
        name = f"{kernel}_kernelILi{D}EE"
    reports = [
        r for r in _build.build_log().split("Compiling entry function")[1:]
        if name in r.split("'")[1]]
    if len(reports) != 1:
        raise AssertionError(f"{len(reports)} ptxas reports for {name}")
    regs = int(re.search(r"Used (\d+) registers", reports[0]).group(1))
    spill = int(re.search(r"(\d+) bytes spill stores", reports[0]).group(1))
    smem = re.search(r"(\d+) bytes smem", reports[0])
    static = int(smem.group(1)) if smem else 0
    return {"registers": regs, "spill_store_bytes": spill,
            "static_shared_bytes": static, "dynamic_shared_bytes": dyn,
            "resident_blocks": resident_blocks(regs, threads, static + dyn),
            "threads": threads, "R": R, "rows_a_pass": rows,
            "passes": -(-Rp // rows)}


def instance_facts(name, threads, dyn):
    """Registers, spill bytes and static shared bytes of the one
    instantiation whose mangled name holds ``name`` (the ptxas report of
    the build), with its launch's ``dyn`` dynamic shared bytes and
    ``threads`` a block: the blocks and warps an SM holds."""
    reports = [
        r for r in _build.build_log().split("Compiling entry function")[1:]
        if name in r.split("'")[1]]
    if len(reports) != 1:
        raise AssertionError(f"{len(reports)} ptxas reports for {name}")
    regs = int(re.search(r"Used (\d+) registers", reports[0]).group(1))
    spill = int(re.search(r"(\d+) bytes spill stores", reports[0]).group(1))
    smem = re.search(r"(\d+) bytes smem", reports[0])
    static = int(smem.group(1)) if smem else 0
    blocks = resident_blocks(regs, threads, static + dyn)
    return {"registers": regs, "spill_store_bytes": spill,
            "static_shared_bytes": static, "dynamic_shared_bytes": dyn,
            "threads": threads, "resident_blocks": blocks,
            "resident_warps": blocks * threads // 32}


def moment_facts(orders, D, C, hmm=False):
    """The build and launch facts of the moment-form backward's
    instantiation at (orders, D, C, h_matmul) (instance_facts; each warp
    one range of 32 entries)."""
    lib = _build.load()
    mask = ktiled._order_rows(orders, D)[0]
    cb = C if D == 2 and C <= 2 else 4
    return instance_facts(
        f"tiled_backward_moments_kernelILi{D}ELi{mask}ELi{cb}"
        f"ELb{int(hmm)}EE", lib.dgs_tiled_backward_moments_block(D),
        lib.dgs_tiled_backward_moments_smem(D, mask, C, int(hmm)))


def sep_facts(orders, D, C, passes):
    """The same of the separable forward's instantiation at (orders, D, C,
    TF32 passes) (each warp one range of 32 samples)."""
    lib = _build.load()
    mask = ktiled._order_rows(orders, D)[0]
    cb = C if D == 2 and C <= 2 else 4
    return instance_facts(
        f"tiled_forward_sep_kernelILi{D}ELi{mask}ELi{cb}ELi{passes}EE",
        lib.dgs_tiled_forward_sep_block(),
        lib.dgs_tiled_forward_sep_smem(D, C))


def hmm_facts(orders, D, C, wrapped):
    """The same of h_matmul's backward at (orders, D, C, wrapped) (each
    warp 16 entries, two warps a 32-entry range)."""
    lib = _build.load()
    mask = ktiled._order_rows(orders, D)[0]
    cb = C if D == 2 and C <= 2 else 4
    return instance_facts(
        f"tiled_backward_hmm_kernelILi{D}ELi{mask}ELi{cb}"
        f"ELb{int(wrapped)}EE", lib.dgs_tiled_backward_hmm_block(),
        lib.dgs_tiled_backward_hmm_smem(D, mask, C))


def straddling_blocks(tiles, T, block):
    """Blocks of ``block`` consecutive sorted rows whose valid tiles (< T)
    are two or more."""
    t = torch.where(tiles < T, tiles, -1)
    t = t[:t.shape[0] // block * block].reshape(-1, block)
    first = torch.where(t >= 0, t, T).amin(dim=1)
    return int((t.amax(dim=1) > first).sum())


def folded_calls(kernel, ev, lo, n, s_lo, s_n, ct, cb, local, packed):
    """(the kernel's call, its plain version's call on operands of a given
    dtype, the floats it must move) of a folded-mode kernel on one
    evaluation's operands (tiled_evaluations) and the step's cotangent."""
    orders, D, C, p = ev["orders"], ev["D"], ev["C"], ev["passes"]
    geom, smp, fold, foldw = ev["geom"], ev["smp"], ev["fold"], ev["foldw"]
    tri = D * (D + 1) // 2
    Ep = geom.shape[1]
    size = lambda *ts: sum(t.numel() for t in ts if t is not None)
    if kernel == "tiled_forward_folded":
        return (lambda: ktiled.tiled_forward_folded(orders, D, C, geom, fold,
                                                    smp, lo, n, passes=p),
                lambda dt=torch.float32: ktiled.tiled_forward_folded_plain(
                    orders, D, C, geom.to(dt), fold.to(dt), smp.to(dt), lo,
                    n),
                (1 + D + tri) * Ep + size(fold, smp, lo, n, packed))
    if kernel == "tiled_backward_fdv":
        return (lambda: ktiled.tiled_backward_fdv(
                    orders, D, C, geom, local, ct, cb, s_lo, s_n, passes=p,
                    h_matmul=ev["hmm"]),
                lambda dt=torch.float32: ktiled.tiled_backward_plain(
                    orders, None, D, C, geom.to(dt), local.to(dt), ct.to(dt),
                    s_lo, s_n, cb=cb.to(dt)),
                size(geom, local, ct, cb, s_lo, s_n) + (D + tri + C) * Ep)
    if kernel == "tiled_backward_fvjp":
        nsel = len(ktiled.fvjp_vz_groups(orders, D))
        return (lambda: ktiled.tiled_backward_fvjp(
                    orders, D, C, geom, fold, foldw, local, cb, s_lo, s_n,
                    passes=p),
                lambda dt=torch.float32: ktiled.tiled_backward_fvjp_plain(
                    orders, D, C, geom.to(dt), fold.to(dt), foldw.to(dt),
                    local.to(dt), cb.to(dt), s_lo, s_n),
                size(geom, fold, foldw, local, cb, s_lo, s_n)
                + (D + tri + C + nsel) * Ep)
    return (lambda: ktiled.tiled_backward_hmm(orders, ev["period"], D, C,
                                              geom, smp, ct, s_lo, s_n,
                                              passes=p),
            lambda dt=torch.float32: ktiled.tiled_backward_plain(
                orders, ev["period"], D, C, geom.to(dt), smp.to(dt),
                ct.to(dt), s_lo, s_n),
            size(geom, smp, ct, s_lo, s_n) + (D + tri + C) * Ep)


def phase_parity_folded(dev):
    """The folded modes' kernels against their plain versions on small
    seeded cases (D = 1, 2, 3 x C = 1, 4, 6 x three orders, four orders and
    (value, laplacian); an open box with full-cover footprints; tiles
    without samples or entries): the folded forward, the folded dvalues
    (with and without h_matmul) and the folded VJP within the general
    limits or FOLD_ERR_RATIO against float64; h_matmul's classic and
    moment-form backwards within the general limits; the 1-pass
    (fast-math) readings of each, outside the fp32 gate, the h_matmul and
    folded-dvalues ones under ONE_PASS_SANITY; the folded VJP's rows
    combined (fvjp_combine) against the classic backward on the same
    operands at FOLD_ATOL_REL; pad and sentinel columns exactly zero; the
    backwards twice, bitwise equal.  D = 3 at four orders (C = 4 and 6: R
    = 1,092 and 1,638) takes several passes of the folded forward and Zd
    windows of the folded VJP (each case reports the instantiations); then
    h_matmul's backward on wrapped operands (D = 1-3, C = 1, 4, 6: the
    per-pair wrap) against the plain backward, twice bitwise equal, its
    1-pass reading under ONE_PASS_SANITY; the phase fails unless some
    64-sample block of the folded forward, some 32-entry block of the folded
    VJP and some block of h_matmul's (two ranges) straddle two tiles.  Then
    the op in
    each folded mode and under h_matmul against the dense masked oracle,
    gradients twice and
    bitwise equal, with the kernels each mode launched.  (The folded
    dvalues are held as the folded forward and VJP are: their value rows
    sum the same expansion, 1.5e-4 of max|ref| from the plain version at
    D = 1, C = 4, four orders, 3,125 samples a tile.)"""
    t_phase = time.perf_counter()
    cases = [(1, 1, THREE), (1, 4, ORDERS), (1, 6, PARTIAL),
             (2, 1, ORDERS), (2, 4, THREE), (2, 6, PARTIAL),
             (3, 1, PARTIAL), (3, 4, THREE), (3, 6, ORDERS)]
    cases += [(3, 4, ORDERS)]   # R = 1,092: several passes and Zd windows
    cases = [(D, 0.03, C, o, False, False) for D, C, o in cases]
    cases += [(2, 0.6, 4, THREE, False, True),    # full cover, open box
              (2, 0.03, 4, ORDERS, True, False)]  # tiles without a side
    one_pass, straddling = {}, {"fwd_64": 0, "bwd_32": 0, "hmm_block": 0}
    for i, (D, sigma, C, orders, holes, open_domain) in enumerate(cases):
        (m, v, covs, con), samples, g, cfg, state = wrap_free_case(
            dev, 90 + i, D, sigma, C, holes, open_domain)
        meta, n_mono, R, Rp = ktiled.folded_layout(orders, D, C)
        _, _, geom, _, fold, foldw = ktiled.prepare_entries(
            state, m, v, con, ktiled.BLOCK_E, cfg=cfg, folded=orders,
            fold_meta=meta, folded_vjp=True)
        mono = ktiled.prepare_samples(
            state, samples, ktiled.BLOCK_N, cfg=cfg,
            folded_deg=ktiled.folded_degree(orders))[0]
        lo, n = ktiled.entry_ranges(state, mono.shape[1])
        s_lo, s_n = ktiled.sample_ranges(state, geom.shape[1])
        K = ktiled.total_unique(orders, D)
        ct = torch.randn((K * C, mono.shape[1]), generator=g, device=dev)
        ev = dict(orders=orders, D=D, C=C, passes=3, geom=geom, smp=mono,
                  fold=fold, foldw=foldw, period=None, hmm=False)
        cb = ktiled.ct_beta_rows(meta, C, ct, mono)
        local = ktiled.local_samples(mono, D)
        dead = dead_entries(geom, state)
        res, ones = {}, {}
        T = state.ent_start.shape[0] - 2
        blocks = {"fwd_64": straddling_blocks(state.s_tile[0], T, 64),
                  "bwd_32": straddling_blocks(state.ent_tile[0], T,
                                              ktiled.BLOCK_E),
                  "hmm_block": straddling_blocks(
                      state.ent_tile[0], T,
                      _build.load().dgs_tiled_backward_hmm_rows())}
        for key, count in blocks.items():
            straddling[key] += count
        facts = {k: folded_facts(k, orders, D, C)
                 for k in ("tiled_forward_folded", "tiled_backward_fdv",
                           "tiled_backward_fvjp")}
        facts["tiled_backward_hmm"] = hmm_facts(orders, D, C, False)
        for kernel, groups in (
                ("tiled_forward_folded", fwd_groups(orders, D, C)),
                ("tiled_backward_fdv", bwd_groups(D, C)),
                ("tiled_backward_fvjp", bwd_groups(D, C))):
            for hmm in ((False, True) if kernel == "tiled_backward_fdv"
                        else (False,)):
                ev["hmm"] = hmm
                call, plain_call, _ = folded_calls(
                    kernel, ev, lo, n, s_lo, s_n, ct, cb, local, None)
                got, again = call(), call()
                ref = plain_call()
                ref64 = plain_call(torch.float64)
                torch.cuda.synchronize()
                key = kernel + ("_hmm" if hmm else "")
                res[key] = folded_check(f"{key} D={D} C={C}", got, ref,
                                        ref64, groups)
                if not torch.equal(got, again):
                    raise AssertionError(f"{key} D={D}: two runs differ")
                if kernel == "tiled_forward_folded":
                    res[key]["pad_columns_zero"] = check_dead_rows(
                        key, got, mono[-1] < 0)
                else:
                    res[key]["sentinel_columns_zero"] = check_dead_rows(
                        key, got, dead)
                if kernel == "tiled_backward_fvjp":
                    classic = ktiled.tiled_backward_plain(
                        orders, None, D, C, ktiled.base_rows(geom, D, C),
                        local, ct, s_lo, s_n)
                    res[key]["combined_vs_classic_err"] = err_fields(
                        compare_rows(ktiled.fvjp_combine(orders, D, C, got,
                                                         geom),
                                     classic, D, C, atol_rel=FOLD_ATOL_REL))
                ev["passes"] = 1
                one = folded_calls(kernel, ev, lo, n, s_lo, s_n, ct, cb,
                                   local, None)[0]()
                ev["passes"] = 3
                ones[key] = float((one - got).abs().max()) / max(
                    float(got.abs().max()), 1e-30)
                if kernel == "tiled_backward_fdv" and \
                        ones[key] > ONE_PASS_SANITY:
                    raise AssertionError(f"1-pass {key} D={D} C={C}: "
                                         f"{ones[key]}")
                del got, again, ref, ref64, one
        # h_matmul in the classic backward (tile-local operands) and in the
        # moment form.
        base = ktiled.base_rows(geom, D, C)
        ev_h = dict(ev, geom=base, smp=local, hmm=True)
        call, plain_call, _ = folded_calls("tiled_backward_hmm", ev_h, lo, n,
                                           s_lo, s_n, ct, None, None, None)
        got = call()
        res["tiled_backward_hmm"] = err_fields(compare_rows(
            got, plain_call(), D, C))
        if not torch.equal(call(), got):
            raise AssertionError(f"h_matmul D={D}: two runs differ")
        res["tiled_backward_hmm"]["sentinel_columns_zero"] = check_dead_rows(
            "h_matmul", got, dead)
        ev_h["passes"] = 1
        one = folded_calls("tiled_backward_hmm", ev_h, lo, n, s_lo, s_n, ct,
                           None, None, None)[0]()
        ones["tiled_backward_hmm"] = float((one - got).abs().max()) / float(
            got.abs().max())
        sgeom = ktiled.prepare_entries(state, m, v, con, ktiled.BLOCK_E,
                                       cfg=cfg, separable=True)[2]
        smono = ktiled.prepare_samples(state, samples, ktiled.BLOCK_N,
                                       cfg=cfg, separable=True)[0]
        rows = ktiled.tiled_backward_moments(orders, D, C, sgeom, smono, ct,
                                             s_lo, s_n, h_matmul=True)
        res["tiled_backward_moments_hmm"] = err_fields(moment_errs(
            rows, ktiled.tiled_backward_moments_plain(
                orders, D, C, sgeom, smono, ct, s_lo, s_n), orders, D))
        for key in ("tiled_backward_hmm",):
            if ones[key] > ONE_PASS_SANITY:
                raise AssertionError(f"1-pass {key} D={D}: {ones[key]}")
        for key, e in ones.items():
            one_pass[key] = max(one_pass.get(key, 0.0), e)
        emit("parity_folded", D=D, sigma=sigma, C=C, orders=list(orders),
             R=R, P=m.shape[0], N=samples.shape[0], holes=holes,
             open_domain=open_domain, entries=int((~dead).sum()),
             **tile_facts(state), straddling_blocks=blocks,
             instantiations=facts, err=res, one_pass_vs_three_pass=ones,
             one_pass_label="outside the fp32 gate")
        del geom, fold, foldw, mono, cb, ct

    # h_matmul on wrapped operands (periodic domain, the per-pair wrap):
    # D = 1-3, C = 1 (one narrow pass), 4, 6 (two passes).
    for D in (1, 2, 3):
        for C in (1, 4, 6):
            _, state, geom, smp, period, P, N, g = small_case(
                dev, 70 + D, D, False, 0.03, C)
            s_lo, s_n = ktiled.sample_ranges(state, geom.shape[1])
            ct = torch.randn((ktiled.total_unique(ORDERS, D) * C,
                              smp.shape[1]), generator=g, device=dev)
            call = lambda p=3: ktiled.tiled_backward_hmm(
                ORDERS, period, D, C, geom, smp, ct, s_lo, s_n, passes=p)
            got, again, one = call(), call(), call(1)
            ref = ktiled.tiled_backward_plain(ORDERS, period, D, C, geom, smp,
                                              ct, s_lo, s_n)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"wrapped h_matmul D={D} C={C}: two "
                                     "runs differ")
            one_err = float((one - got).abs().max()) / float(got.abs().max())
            if one_err > ONE_PASS_SANITY:
                raise AssertionError(f"1-pass wrapped h_matmul D={D} C={C}: "
                                     f"{one_err}")
            T = state.ent_start.shape[0] - 2
            blocks = straddling_blocks(
                state.ent_tile[0], T,
                _build.load().dgs_tiled_backward_hmm_rows())
            straddling["hmm_block"] += blocks
            emit("parity_folded_hmm_wrapped", D=D, C=C, P=P, N=N,
                 period=period, err=err_fields(compare_rows(got, ref, D, C)),
                 sentinel_columns_zero=check_dead_rows(
                     "wrapped h_matmul", got, dead_entries(geom, state)),
                 one_pass_vs_three_pass=one_err,
                 one_pass_label="outside the fp32 gate",
                 straddling_blocks=blocks, **tile_facts(state),
                 instantiation=hmm_facts(ORDERS, D, C, True))
            del geom, smp, ct, got, again, one, ref

    for D in (1, 2, 3):
        gen = torch.Generator(device=dev).manual_seed(60 + D)
        field = init_field(gen, 300, D, 3, sigma=0.05)
        samples = 2.0 * torch.rand((2000, D), generator=gen, device=dev) - 1.0
        with torch.no_grad():
            m, v = field.means.detach(), field.values.detach()
            cov, con = field.covariances(), field.conics()
        cfg, plan = planned_config(
            SamplerConfig(tile_size=0.25).with_dims(D), m, cov, samples)
        if not plan["safe_unwrapped"]:
            raise AssertionError(f"D={D}: no wrap-free certificate")
        state = binning.build(cfg, m, cov, samples)
        mask = binning.pair_mask_dense(cfg, state, samples, 300)

        def loss_oracle(m_, v_, c_):
            return sum((oracle.evaluate(o, m_, v_, c_, samples,
                                        period=cfg.period,
                                        pair_mask=mask) ** 2).sum()
                       for o in ORDERS)

        def grads(loss):
            args = [a.clone().requires_grad_() for a in (m, v, con)]
            return torch.autograd.grad(loss(*args), args)

        ref = grads(loss_oracle)
        refs = [oracle.evaluate(o, m, v, con, samples, period=cfg.period,
                                pair_mask=mask) for o in ORDERS]
        for name, env, expect in FOLDED_RUNS:
            mcfg = dataclasses.replace(
                cfg, **{FOLDED_FLAGS[k]: True for k in env})

            def loss_modes(m_, v_, c_, mcfg=mcfg):
                outs = sampling.sample_tiled_multi(
                    ORDERS, mcfg, m_, v_, c_, samples, state, unwrapped=True)
                return sum((o ** 2).sum() for o in outs)

            reset_launches()
            got = grads(loss_modes)
            launched = read_launches()
            if any(bool(launched[k]) != on for k, on in expect.items()):
                raise AssertionError(f"{name} D={D} launched {launched}")
            again = grads(loss_modes)
            outs = sampling.sample_tiled_multi(ORDERS, mcfg, m, v, con,
                                               samples, state, unwrapped=True)
            atol = ATOL_REL if name == "h_matmul" else FOLD_ATOL_REL
            err = {o: check_close(f"{name} vs oracle D={D} {o}", a, r, RTOL,
                                  atol)[0]
                   for o, a, r in zip(ORDERS, outs, refs)}
            for pname, a, b, r in zip(("means", "values", "conics"), got,
                                      again, ref):
                if not torch.equal(a, b):
                    raise AssertionError(f"{name} D={D} d{pname}: two runs "
                                         "differ")
                err[f"d{pname}"] = check_close(
                    f"{name} grads vs oracle D={D} d{pname}", a, r,
                    GRAD_RTOL, atol)[0]
            emit("parity_folded_oracle", D=D, P=300, N=2000, mode=name,
                 launches=launched, max_abs_err=err, bitwise_repeatable=True)
    if not all(straddling.values()):
        raise AssertionError(f"no block straddles two tiles: {straddling}")
    emit("parity_folded_summary", one_pass_worst=one_pass,
         straddling_blocks=straddling,
         seconds=time.perf_counter() - t_phase)
    return one_pass


def folded_workload(w, env):
    """Workload ``w`` (bench's, planned once) with the folded knobs of
    ``env`` set in its config; the chunked sample side is rebuilt where the
    modes ask for another monomial operand."""
    cfg = dataclasses.replace(
        w.cfg, **{FOLDED_FLAGS[k]: v == "1" for k, v in env.items()})
    sb = w.sb
    if w.method == "chunked":
        sb = sampling_chunked.chunk_samples(cfg, w.samples, w.plan,
                                            cfg.block_n)
    return w._replace(cfg=cfg, sb=sb)


def phase_folded_slice(dev, steps=10):
    """The folded modes and h_matmul on their path at full width: the D = 3
    chunked bench step (tools.bench at BENCH_D=3: 100k x 1M, tile 0.2,
    axis radii, ellipsoid cull, C = 4, three orders) classic, then (a)
    BENCH_FOLDED=1, (b) + BENCH_FDV=1, (c) + BENCH_FVJP=1 and (d)
    BENCH_HMM=1, one plan for all: ``steps`` warm steps each (host median
    and range, busy ms, device items, peak bytes, launches: each step ran
    the kernels its mode names), each kernel's CUDA-event ms on its own
    operands beside kernels 1-2 of the classic step, the plain versions'
    ms once (the folded forward and VJP also against float64), the
    gradients against the classic step's at FOLD_ATOL_REL; for the folded
    forward, dvalues and VJP also their one-pass ms and their
    instantiations (registers, spills, shared bytes, resident blocks,
    passes: folded_facts), for kernels 1-2 theirs.  A step at all four
    orders under (b) checks that the folded dvalues turned themselves off
    (the beta-expanded cotangent is 4.4 GB, above CT_BETA_MAX_BYTES); the
    folded forward, dvalues and VJP are then timed on that step's operands
    (R = 1,092: the tall case).  Then the D = 2 headline step classic, under
    (c) and under (d).  Returns (launches by path, kernel numbers by
    run)."""
    launches, kernels = {}, {}
    t_phase = time.perf_counter()
    for D in (3, 2):
        t0 = time.perf_counter()
        _, base = modes_workload(dev, {}, D=D)
        t_plan = time.perf_counter() - t0
        # Each run's steps move the shared field: every run starts from the
        # same parameters.
        start = [p.detach().clone() for p in base.field.parameters()]

        def restore():
            with torch.no_grad():
                for p, p0 in zip(base.field.parameters(), start):
                    p.copy_(p0)

        fields, base_grads, ev, launched = mode_step(
            dev, f"d{D}_classic", base, (False, False), steps)
        base_loss = fields["loss"]
        fields["kernels"] = mode_kernel_numbers(
            ev, ("tiled_forward", "tiled_backward"))
        fields["seconds"]["plan"] = t_plan
        kernels[f"d{D}_classic"] = fields["kernels"]
        emit("folded_slice", **fields)
        del ev
        runs = FOLDED_RUNS if D == 3 else FOLDED_RUNS[2:]
        for name, env, expect in runs:
            restore()
            w = folded_workload(base, env)
            fields, grads, ev, launched = mode_step(
                dev, f"d{D}_{name}", w, expect, steps)
            # Each kernel timed (and its plain version, at D = 3) on the
            # run that first launches it; at D = 2 the folded forward and
            # dvalues on (c)'s operands (the same geom and cotangent).
            sides = {"folded": ["tiled_forward_folded"],
                     "folded_dvals": ["tiled_backward_fdv"],
                     "folded_vjp": (["tiled_backward_fvjp"] if D == 3 else
                                    ["tiled_forward_folded",
                                     "tiled_backward_fdv",
                                     "tiled_backward_fvjp"]),
                     "h_matmul": ["tiled_backward_hmm"]}[name]
            t0 = time.perf_counter()
            fields["kernels"] = mode_kernel_numbers(ev, sides, plain=D == 3)
            fields["seconds"]["kernels"] = time.perf_counter() - t0
            fields["vs_classic"] = err_fields(
                {pname: check_close(f"d{D} {name} vs classic d{pname}", a, b,
                                    GRAD_RTOL, FOLD_ATOL_REL)
                 for pname, a, b in zip(FIELD_PARAMS, grads, base_grads)})
            fields["vs_classic"]["loss_rel"] = abs(
                fields["loss"] - base_loss) / abs(base_loss)
            kernels[f"d{D}_{name}"] = fields["kernels"]
            launches[f"folded_d{D}_{name}"] = launched
            emit("folded_slice", **fields)
            del ev, w
            torch.cuda.empty_cache()
        if D == 3:
            # Four orders: the folded dvalues turn themselves off.
            w4 = folded_workload(base._replace(orders=ORDERS),
                                 FOLDED_RUNS[1][1])
            Np = ktiled._round_up(w4.samples.shape[0], ktiled.BLOCK_N)
            beta = sampling.ct_beta_bytes(ORDERS, 3, 4, Np)
            if beta <= ktiled.CT_BETA_MAX_BYTES:
                raise AssertionError(f"four orders: the beta-expanded "
                                     f"cotangent's {beta} bytes fit the gate")
            restore()
            reset_launches()
            value, _ = bench.loss(w4)
            value.backward()
            torch.cuda.synchronize()
            got = read_launches()
            if not (got["tiled_forward_folded"] == 1
                    and got["tiled_backward"] == 1
                    and got["tiled_backward_fdv"] == 0):
                raise AssertionError(f"four orders under BENCH_FDV=1 "
                                     f"launched {got}")
            emit("folded_slice", run="d3_folded_dvals_four_orders",
                 launches=got, ct_beta_bytes=beta,
                 ct_beta_max_bytes=ktiled.CT_BETA_MAX_BYTES,
                 folded_dvals_off=True)
            del value
            # The tall-R case: the folded forward, dvalues and VJP on this
            # step's four-order operands (R = 1,092: the forward's and the
            # folded dvalues' three passes, the VJP's Zd windows), with the
            # foldw rows the step did not build.
            t0 = time.perf_counter()
            value, _ = bench.loss(w4)
            (ev4,) = tiled_evaluations(value)
            del value
            tri = 6
            ev4["foldw"] = ktiled.build_folded(
                ORDERS, 3, 4, ev4["geom"][1:1 + 3 + tri + 4].T,
                formulas.folded_structure(ORDERS, 3)[0], vjp=True)[2]
            kernels["d3_tall_four_orders"] = mode_kernel_numbers(
                ev4, ["tiled_forward_folded", "tiled_backward_fdv",
                      "tiled_backward_fvjp"], plain=False)
            emit("folded_slice", run="d3_tall_four_orders",
                 kernels=kernels["d3_tall_four_orders"],
                 seconds=time.perf_counter() - t0)
            del w4, ev4
            torch.cuda.empty_cache()
        del base
        torch.cuda.empty_cache()
    emit("folded_slice_summary", seconds=time.perf_counter() - t_phase)
    return launches, kernels


def folded_times(dev):
    """python3 chip_smoke.py --folded: the two folded phases alone."""
    one_pass = phase_parity_folded(dev)
    launches, kernels = phase_folded_slice(dev)
    emit("folded_summary", one_pass_worst=one_pass, launches=launches,
         kernels=kernels)


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device()
    dev = torch.device("cuda", 0)
    build = phase_build()
    modes = {"--tiled": tiled_times, "--dense": dense_times,
             "--agg": agg_times, "--segment": segment_times,
             "--chunked": chunked_times, "--sharded": sharded_times,
             "--tools": phase_tools, "--modes": modes_times,
             "--folded": folded_times, "--binning": binning_times}
    if sys.argv[1:]:
        for mode in sys.argv[1:]:
            modes[mode](dev)
        return
    agg_spills = {k: b for k, b in build["spilling_kernels"].items()
                  if k.startswith("agg_")}
    if agg_spills:
        raise AssertionError(f"aggregation kernels spill: {agg_spills}")
    mode_spills = {k: b for k, b in build["spilling_kernels"].items()
                   if k.startswith(("tiled_forward_sep",
                                    "tiled_backward_moments",
                                    "tiled_forward_folded",
                                    "tiled_backward_fdv",
                                    "tiled_backward_fvjp",
                                    "tiled_backward_hmm",
                                    "tiled_backward_kernel"))}
    if mode_spills:
        raise AssertionError(f"mode kernels spill: {mode_spills}")
    # The many-line parity phases first, the measured paths after them, so
    # that the end of the output holds every number of the kernels line.
    phase_parity(dev)
    phase_parity_bwd(dev)
    phase_parity_dense(dev)
    phase_parity_dense_bwd(dev)
    phase_parity_agg(dev)
    phase_parity_agg_oracle(dev)
    seg_dynamics = phase_parity_dynamics(dev)
    by_shape = phase_parity_paths(dev)
    phase_parity_chunked(dev)
    phase_parity_modes(dev)
    phase_parity_folded(dev)
    k_keys = phase_parity_binning(dev)
    slice_launches, k_fwd = phase_slice(dev)
    train_launches, k_bwd, k_seg, train_step = phase_train_step(dev)
    k_seg["d3_r8"], k_seg["d3_real"] = phase_segment(dev)
    chunked_launches, chunked, chunked_train_step = phase_chunked_slice(dev)
    modes_launches, k_modes = phase_modes_slice(dev)
    folded_launches, k_folded = phase_folded_slice(dev)
    for n_orders, fields in chunked.items():
        by_shape[f"chunked_d3_{n_orders}_orders"] = {
            **fields["kernels"], "segment_sum": fields["segment_sum"]}
    k_seg["by_shape"] = {"dynamics_agg": seg_dynamics, **{
        p: v["segment_sum"] for p, v in by_shape.items()}}
    pigs_launches = phase_pigs(dev)
    (dense_eval_launches, dense_step_launches, k_dfwd, k_dbwd,
     dense_step) = phase_dense_slice(dev)
    pigs_dense_launches = phase_pigs_dense(dev)
    (agg_build_launches, agg_launches, agg_step_launches, k_agg,
     agg_step) = phase_agg_slice(dev)
    dynamics_launches = phase_dynamics(dev)
    sharded_launches = phase_sharded(dev)
    two_rank_launches = phase_sharded_two_ranks(dev)
    phase_profile(dev, train_step, dense_step, agg_step, chunked_train_step)
    tool_launches = phase_tools(dev)
    paths = {"slice": slice_launches, "train_step": train_launches,
             "pigs": pigs_launches, "dense_slice": dense_eval_launches,
             "dense_step": dense_step_launches,
             "pigs_dense": pigs_dense_launches,
             "agg_structure": agg_build_launches, "agg_slice": agg_launches,
             "agg_step": agg_step_launches, "dynamics": dynamics_launches,
             "sharded": sharded_launches,
             "sharded_two_ranks": two_rank_launches, **chunked_launches,
             **modes_launches, **folded_launches, **tool_launches}
    # name: (source, the TPU kernel it replaces, its main path, numbers)
    kernels = {
        "tiled_forward": ("tiled_forward.cu", "dgs_tpu/kernels/tiled.py:727",
                          "slice", k_fwd),
        "tiled_backward": ("tiled_backward.cu",
                           "dgs_tpu/kernels/tiled.py:1338", "train_step",
                           k_bwd),
        "dense_forward": ("dense_forward.cu", "dgs_tpu/kernels/dense.py:149",
                          "dense_slice", k_dfwd),
        "dense_backward": ("dense_backward.cu",
                           "dgs_tpu/kernels/dense.py:220", "dense_step",
                           k_dbwd),
        "agg_totals": ("agg_totals.cu", "dgs_tpu/kernels/aggregate.py:223",
                       "agg_structure", k_agg["totals"]),
        "agg_forward": ("agg_forward.cu", "dgs_tpu/kernels/aggregate.py:329",
                        "agg_slice", k_agg["forward"]),
        "agg_backward": ("agg_backward.cu",
                         "dgs_tpu/kernels/aggregate.py:485", "agg_step",
                         k_agg["backward"]),
        # Kernels 1-2's separable and moment branches, on the D = 3
        # chunked bench step under BENCH_SEP=1 BENCH_MOMENTS=1 (3 passes).
        "tiled_forward_sep": ("tiled_forward_sep.cu",
                              "dgs_tpu/kernels/tiled.py:535",
                              "modes_sep_moments",
                              k_modes["sep_moments"]["tiled_forward_sep"]),
        "tiled_backward_moments": (
            "tiled_backward_moments.cu", "dgs_tpu/kernels/tiled.py:1212",
            "modes_sep_moments",
            k_modes["sep_moments"]["tiled_backward_moments"]),
        # Kernels 1-2's folded branches and h_matmul, each on the D = 3
        # chunked bench step of the run that first launches it.
        "tiled_forward_folded": (
            "tiled_forward_folded.cu", "dgs_tpu/kernels/tiled.py:616",
            "folded_d3_folded", k_folded["d3_folded"]["tiled_forward_folded"]),
        "tiled_backward_fdv": (
            "tiled_backward_folded.cu", "dgs_tpu/kernels/tiled.py:1117",
            "folded_d3_folded_dvals",
            k_folded["d3_folded_dvals"]["tiled_backward_fdv"]),
        "tiled_backward_fvjp": (
            "tiled_backward_fvjp.cu", "dgs_tpu/kernels/tiled.py:932",
            "folded_d3_folded_vjp",
            k_folded["d3_folded_vjp"]["tiled_backward_fvjp"]),
        "tiled_backward_hmm": (
            "tiled_backward_hmm.cu", "dgs_tpu/kernels/tiled.py:1098",
            "folded_d3_h_matmul",
            k_folded["d3_h_matmul"]["tiled_backward_hmm"]),
        # Not a TPU kernel: the reference's segment-sum is an XLA op.
        "segment_sum": ("segment_sum.cu", "dgs_tpu/ops/sampling.py:409",
                        "train_step", k_seg),
        # Not a TPU kernel either: the reference builds the binning's keys
        # with XLA's elementwise ops.
        "binning_keys": ("binning_keys.cu", "dgs_tpu/binning/grid.py:212",
                         "chunked_step", k_keys),
    }
    for name, (_, _, main_path, _) in kernels.items():
        if paths[main_path][name] < 1:
            raise AssertionError(f"{name} never launched on {main_path}")
    for _, _, _, k in kernels.values():
        k["share"] = k["bound_ms"] / k["ms"]
    # The two tiled kernels' rows also carry their times at the trainers'
    # shapes.
    for name in ("tiled_forward", "tiled_backward"):
        kernels[name][3]["by_shape"] = {p: v[name]
                                        for p, v in by_shape.items()}
    emit("card_and_build", nvidia_smi=smi, spin=_spin, **build)
    # No single PyTorch call computes any of the seven TPU kernels' functions
    # (a fused multi-order Gaussian-mixture evaluation or its VJP, in any of
    # their modes; a masked, density-normalised attention with a sinusoidal
    # offset code, or its six gradients), so their library_ms is null; the
    # segment-sum's is index_add_'s.
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"dgs_tpu_torch/csrc/{source}", "replaces": replaces,
         "launches": paths[main_path][name], "library_ms": None, **numbers,
         "launches_by_path": {p: counts[name] for p, counts in paths.items()}}
        for name, (source, replaces, main_path, numbers) in kernels.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
