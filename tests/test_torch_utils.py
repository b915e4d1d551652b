"""dgs_tpu_torch.utils: the metrics log, the checkpoint of training state,
the profiling helpers (on synthetic traces and intervals), the roofline
counts against dgs_tpu's and the port's pinned per-pair counts, and
checked / throw, the twin of dgs_tpu's checkify wrappers."""

import gzip
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgs_tpu.binning import grid as jgrid
from dgs_tpu.config import SamplerConfig as JConfig
from dgs_tpu.utils import roofline as jroofline
from dgs_tpu_torch.binning import grid as tgrid
from dgs_tpu_torch.config import ORDERS, SamplerConfig as TConfig
from dgs_tpu_torch.models import dynamics, pigs
from dgs_tpu_torch.models.field import init_field
from dgs_tpu_torch.utils import checkpoint, debug, metrics, profiling, \
    roofline

from conftest import make_gaussians, make_samples

torch.set_num_threads(2)

SLICE = ("value", "derivative", "laplacian")


def test_jsonl_logger_writes_one_record_a_line(tmp_path):
    path = tmp_path / "log.jsonl"
    log = metrics.JsonlLogger(str(path))
    log.log({"step": 0, "loss": 1.5})
    log.log({"step": 1, "t": 7.0})
    log.close()
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [x["step"] for x in lines] == [0, 1]
    assert lines[0]["loss"] == 1.5 and lines[0]["t"] >= 0.0
    assert lines[1]["t"] == 7.0
    stream = io.StringIO()
    log = metrics.JsonlLogger(stream=stream)
    log.log({"a": 1})
    log.close()                       # a stream it did not open stays open
    assert json.loads(stream.getvalue())["a"] == 1
    metrics.JsonlLogger().log({"dropped": True})


def test_pigs_train_logs_once_per_chunk():
    """models.pigs.train(logger=...) writes one record per chunk of
    log_every steps, the history's own records."""
    stream = io.StringIO()
    _, history = pigs.train(
        TConfig(tile_size=0.25), P=24, steps=5, n_collocation=64,
        log_every=2, method="dense", logger=metrics.JsonlLogger(
            stream=stream), device="cpu")
    lines = [json.loads(x) for x in stream.getvalue().splitlines()]
    assert len(lines) == len(history) == 3
    assert [x["step"] for x in lines] == [1, 3, 4]
    for line, rec in zip(lines, history):
        assert line["loss"] == rec["loss"] and "t" in line


def _pigs_state(seed, P=40):
    g = torch.Generator().manual_seed(seed)
    field = init_field(g, P, 2, 1, sigma=0.1)
    opt = torch.optim.Adam(field.parameters(), lr=3e-3, eps=1e-8)
    return pigs.TrainState(field, opt, 0)


def _pigs_steps(state, batches, u_star, f_rhs):
    cfg = TConfig(tile_size=0.25, max_tiles_per_gaussian=6)
    for col, dx in batches:
        pigs.train_step(cfg, state.field, state.optimizer, col, dx,
                        u_star(dx), f_rhs)
    return state._replace(step=state.step + len(batches))


def test_checkpoint_resumes_training_bitwise(tmp_path):
    """A TrainState saved after two steps and restored into a template of
    another seed takes three more steps bitwise equal to three from the
    original (field, Adam moments and step counter all come back)."""
    u_star, f_rhs = pigs.manufactured_solution(2)
    rng = np.random.default_rng(4)
    batches = [(torch.from_numpy(make_samples(rng, 96, 2)),
                torch.from_numpy(make_samples(rng, 24, 2)))
               for _ in range(5)]
    state = _pigs_steps(_pigs_state(0), batches[:2], u_star, f_rhs)
    path = tmp_path / "ckpt" / "state.pt"
    checkpoint.save(str(path), state)
    restored = checkpoint.restore(str(path), _pigs_state(1))
    assert restored.step == state.step == 2
    for name, p in state.field.named_parameters():
        assert torch.equal(p, dict(restored.field.named_parameters())[name])
    a = _pigs_steps(state, batches[2:], u_star, f_rhs)
    b = _pigs_steps(restored, batches[2:], u_star, f_rhs)
    assert a.step == b.step == 5
    for (name, p), q in zip(a.field.named_parameters(),
                            b.field.parameters()):
        assert torch.equal(p, q), name


def test_checkpoint_dynamics_params_roundtrip(tmp_path):
    g = torch.Generator().manual_seed(0)
    params = dynamics.init_dynamics_params(g, 30, 2, 2, ladder=True)
    path = str(tmp_path / "dyn.pt")
    checkpoint.save(path, params)
    other = dynamics.init_dynamics_params(torch.Generator().manual_seed(1),
                                          30, 2, 2, ladder=True)
    got = checkpoint.restore(path, other)
    assert got is other
    for a, b in zip(params, got):
        assert torch.equal(a, b) and b.requires_grad
    with pytest.raises(ValueError, match="holds a DynamicsParams"):
        checkpoint.restore(path, _pigs_state(0))
    with pytest.raises(ValueError, match="queries has shape"):
        checkpoint.restore(path, dynamics.init_dynamics_params(
            torch.Generator().manual_seed(1), 31, 2, 2, ladder=True))
    with pytest.raises(TypeError, match="cannot save"):
        checkpoint.save(path, {"not": "a state"})


def _chrome_trace(path):
    """A small Chrome trace as torch.profiler writes it: host ops and a
    scope with External ids, two kernels and a copy on the device, a
    runtime event and a device annotation that are not device work."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "step", "ts": 0,
         "dur": 100, "args": {"External id": 1}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 1, "dur": 5,
         "args": {"External id": 2}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 10,
         "dur": 5, "args": {"External id": 3}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 2, "dur": 1, "args": {"External id": 2}},
        {"ph": "X", "cat": "kernel", "name": "mul_kernel", "ts": 20,
         "dur": 30, "args": {"External id": 2}},
        {"ph": "X", "cat": "kernel", "name": "mul_kernel", "ts": 60,
         "dur": 10, "args": {"External id": 2}},
        {"ph": "X", "cat": "kernel", "name": "tiled_forward_kernel",
         "ts": 70, "dur": 50, "args": {"External id": 1}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 120,
         "dur": 4, "args": {"External id": 3}},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "step", "ts": 20,
         "dur": 104, "args": {}},
    ]
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": ev}, f)


def test_device_op_times_on_a_synthetic_trace(tmp_path):
    _chrome_trace(tmp_path / "trace_00000000000000000001.json.gz")
    (tmp_path / "trace_00000000000000000000.json").write_text(
        json.dumps({"traceEvents": []}))
    rows = profiling.device_op_times(str(tmp_path), steps=2)
    assert rows == [
        {"name": "tiled_forward_kernel", "ms_per_step": 0.025, "calls": 1,
         "source": "step"},
        {"name": "mul_kernel", "ms_per_step": 0.02, "calls": 2,
         "source": "aten::mul"},
        {"name": "Memcpy DtoH", "ms_per_step": 0.002, "calls": 1,
         "source": "aten::copy_"},
    ]
    assert len(profiling.device_op_times(str(tmp_path), top=1)) == 1
    with pytest.raises(FileNotFoundError):
        profiling.device_op_times(str(tmp_path / "none"))


def test_device_scope_times_on_a_synthetic_trace(tmp_path):
    """Device time by the port's innermost function around the launching
    op; autograd's backward ops by their forward op's function (the same
    sequence number); none outside the package."""
    pkg = "dgs_tpu_torch/binning/grid.py(175): duplicate_entries"
    ev = [
        {"ph": "X", "cat": "python_function", "name": "bench.py(1): <module>",
         "ts": 0, "dur": 1000, "tid": 1, "args": {}},
        {"ph": "X", "cat": "python_function", "name": "/x/" + pkg,
         "ts": 10, "dur": 100, "tid": 1, "args": {}},
        # An op before the node's creation records its sequence number too.
        {"ph": "X", "cat": "cpu_op", "name": "aten::empty", "ts": 2,
         "dur": 3, "tid": 1, "args": {"Sequence number": 7}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 20,
         "dur": 10, "tid": 1,
         "args": {"External id": 1, "Sequence number": 7}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 200,
         "dur": 10, "tid": 1, "args": {"External id": 2}},
        {"ph": "X", "cat": "cpu_op",
         "name": "autograd::engine::evaluate_function: MulBackward0",
         "ts": 300, "dur": 50, "tid": 2, "args": {"Sequence number": 7}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 310,
         "dur": 5, "tid": 2, "args": {"External id": 3,
                                      "Sequence number": 7}},
        {"ph": "X", "cat": "kernel", "name": "mul_kernel", "ts": 40,
         "dur": 30, "args": {"External id": 1}},
        {"ph": "X", "cat": "kernel", "name": "add_kernel", "ts": 220,
         "dur": 20, "args": {"External id": 2}},
        {"ph": "X", "cat": "kernel", "name": "mul_kernel", "ts": 330,
         "dur": 10, "args": {"External id": 3}},
    ]
    with gzip.open(tmp_path / "trace_1.json.gz", "wt") as f:
        json.dump({"traceEvents": ev}, f)
    assert profiling.device_scope_times(str(tmp_path), steps=2) == [
        {"scope": pkg, "ms_per_step": 0.015, "items": 1},
        {"scope": "", "ms_per_step": 0.01, "items": 1},
        {"scope": "backward of " + pkg, "ms_per_step": 0.005, "items": 1},
    ]


def test_trace_writes_a_readable_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.named_scope("square"):
            torch.arange(64.0).pow(2).sum()
    assert isinstance(profiling.device_op_times(str(tmp_path)), list)
    assert isinstance(profiling.device_scope_times(str(tmp_path)), list)


@pytest.mark.parametrize("spans,want", [
    ([], 0.0),
    ([(0.0, 1.0)], 1.0),
    ([(0.0, 2.0), (1.0, 3.0)], 3.0),              # overlapping
    ([(0.0, 10.0), (2.0, 3.0), (4.0, 5.0)], 10.0),  # nested
    ([(5.0, 6.0), (0.0, 1.0), (1.0, 2.0)], 3.0),  # unsorted, touching
    ([(0.0, 1.0), (3.0, 4.5)], 2.5),              # a gap
])
def test_interval_union(spans, want):
    assert profiling.interval_union(spans) == want


def test_pair_count_matches_dgs_tpu(rng):
    m, _, cov, _ = make_gaussians(rng, 300, 2, 1, sigma_range=(0.02, 0.1))
    s = make_samples(rng, 2000, 2)
    kw = dict(tile_size=0.1275, max_tiles_per_gaussian=8,
              entry_capacity_factor=40.0)
    js = jgrid.build(JConfig(**kw), *map(jnp.asarray, (m, cov, s)))
    ts = tgrid.build(TConfig(**kw), *map(torch.from_numpy, (m, cov, s)))
    T = tgrid.num_tiles(TConfig(**kw), 2)
    got = roofline.pair_count(ts.ent_tile.numpy(), T, ts.s_tile.numpy())
    assert got == jroofline.pair_count(np.asarray(js.ent_tile), T,
                                       np.asarray(js.s_tile)) > 0
    # Every same-tile (entry, sample) pair, counted the long way.
    e = ts.ent_tile[0][ts.ent_tile[0] < T]
    assert got == int((e[:, None] == ts.s_tile[0][None, :]).sum())


def test_pair_ops_pinned():
    """The per-pair operation counts the bounds rest on: 42 / 110 at the
    headline (D = 2, three orders, C = 4, unwrapped), 161 / 391 at D = 3,
    C = 4, all four orders, wrapped (152 / 382 unwrapped)."""
    assert roofline.pair_ops(2, SLICE, 4, False, False) == (42, 1)
    assert roofline.pair_ops(2, SLICE, 4, False, True) == (110, 1)
    assert roofline.pair_ops(3, ORDERS, 4, True, False) == (161, 1)
    assert roofline.pair_ops(3, ORDERS, 4, True, True) == (391, 1)
    assert roofline.pair_ops(3, ORDERS, 4, False, False) == (152, 1)
    b = roofline.kernel_bound(10 ** 9, 0, 3, ORDERS, 4, False, False)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(1e3 * 152e9 / 33.5e12)
    a = roofline.agg_bound("totals", 0, 0, 3.35e9, 2, 8, 8, 4, False)
    assert a == {"bound_ms": pytest.approx(4.0), "bound_by": "bytes"}


@pytest.mark.parametrize("D,orders,kind,passes,want", [
    (3, SLICE, "moments", 3, (146, 1, 66)),
    (2, SLICE, "moments", 3, (85, 1, 36)),
    (3, ("value",), "moments", 3, (26, 1, 30)),
    (3, SLICE, "separable", 3, (56, 1, 66)),
    (3, SLICE, "separable", 1, (56, 1, 22)),
    (3, SLICE, "folded", 3, (17, 1, 876)),
    (2, SLICE, "folded", 1, (10, 1, 100)),
    (3, SLICE, "folded_dvals", 3, (152, 1, 876)),
    (3, SLICE, "folded_vjp", 3, (53, 1, 4380)),
    (2, SLICE, "folded_vjp", 1, (29, 1, 400)),
    (3, SLICE, "h_matmul", 3, (152, 1, 120)),
])
def test_mode_pair_ops_pinned(D, orders, kind, passes, want):
    """The kernel modes' per-pair counts: the moment form contracts G S0
    against the 1 + D + tri monomials and, where the orders have W rows,
    G W_l against [1, x_l] (D (1 + D) more multiply-adds a pass), both at
    the TF32 rate as dgs_tpu's _moment_rows does on the MXU; only the D
    multiplies G W_l stay fp32 (at D = 3, three orders: 10 + 12 = 22
    multiply-adds a pass, 66 at 3 passes).  The folded modes contract R
    rows a pair (R = 292 at D = 3, three orders, C = 4): the forward after
    G alone, the folded dvalues in place of the K C value FMAs, the folded
    VJP (1 + D) R for S0 and W_l and R for Zd; h_matmul K C in place of
    the h FMAs."""
    assert roofline.mode_pair_ops(D, orders, 4, kind, passes) == want
    b = roofline.mode_bound(10 ** 9, 0, D, orders, 4, kind, passes)
    assert b == {"bound_ms": pytest.approx(1e3 * max(
        want[0] * 1e9 / roofline.FP32_INSTR_S,
        want[1] * 1e9 / roofline.SFU_OPS_S,
        want[2] * 1e9 / roofline.TF32_MAC_S)), "bound_by": "operations"}


@pytest.mark.parametrize("folded", [True, False])
@pytest.mark.parametrize("D", [1, 2, 3])
def test_pair_flops_macs_match_dgs_tpu(D, folded):
    """pair_flops' contraction multiply-adds equal dgs_tpu's mxu_macs (R
    forward and R backward folded, K C each classic); the folded step's
    roofline adds the tensor cores' time and the folded operands' bytes."""
    for orders in (SLICE, ORDERS, ("value",)):
        got = roofline.pair_flops(orders, D, 4, folded)
        assert got[1] == jroofline.pair_flops(orders, D, 4, folded)[1]
    on = roofline.step_roofline(SLICE, D, 4, 10 ** 9, 10 ** 6, 10 ** 6,
                                folded=True)
    off = roofline.step_roofline(SLICE, D, 4, 10 ** 9, 10 ** 6, 10 ** 6)
    assert on["sol_mxu_s"] == pytest.approx(
        10 ** 9 * 3 * roofline.pair_flops(SLICE, D, 4)[1]
        / roofline.TF32_MAC_S)
    assert on["sol_hbm_s"] > off["sol_hbm_s"] and off["sol_mxu_s"] == 0.0


def test_step_roofline_keys_and_bound():
    got = roofline.step_roofline(SLICE, 2, 4, 198_446_456, 1_000_000,
                                 321_920)
    assert set(got) == set(jroofline.step_roofline(SLICE, 2, 4, 10, 10, 10))
    assert got["flops_per_step"] == 198_446_456 * (42 + 110)
    assert got["sol_vpu_s"] == pytest.approx(198_446_456 * 152 / 33.5e12)
    assert got["sol_step_s"] == max(got["sol_vpu_s"], got["sol_hbm_s"])
    assert got["bound"] == "vpu" and got["sol_mxu_s"] == 0.0
    low = roofline.step_roofline(SLICE, 2, 4, 0, 1_000_000, 321_920)
    assert low["bound"] == "hbm" and low["sol_hbm_s"] > 0.0


def _pigs_loss_and_grads(field, x, u_star, f_rhs):
    loss, _ = pigs.pigs_loss(TConfig(), field, x, x, u_star(x), f_rhs,
                             method="dense")
    loss.backward()
    return loss.detach(), [p.grad for p in field.parameters()]


def test_checked_step_localizes_injected_nan():
    """Twin of test_pigs.py's checkify test: a PIGS loss + gradient step
    under debug.checked passes on clean parameters and, with a NaN injected
    into one mean, gives an error that throw() raises naming the NaN."""
    u_star, f_rhs = pigs.manufactured_solution(2)
    g = torch.Generator().manual_seed(1)
    field = init_field(g, 32, 2, 1, sigma=0.2)
    x = 2.0 * torch.rand((64, 2), generator=g) - 1.0
    step = debug.checked(_pigs_loss_and_grads)
    err, (loss, grads) = step(field, x, u_star, f_rhs)
    debug.throw(err)
    assert err.get() is None and bool(torch.isfinite(loss))
    with torch.no_grad():
        field.means[3, 0] = float("nan")
    field.zero_grad()
    err, _ = step(field, x, u_star, f_rhs)
    with pytest.raises(FloatingPointError, match="nan"):
        debug.throw(err)
    with pytest.raises(FloatingPointError, match="nan"):
        err.throw()


def test_checked_names_a_non_finite_output():
    err, out = debug.checked(lambda t: {"a": t, "b": (t, 1.0 / t)})(
        torch.tensor([1.0, 0.0]))
    with pytest.raises(FloatingPointError, match=r"output\['b'\]\[1\]"):
        err.throw()
    assert out["a"].shape == (2,)
    err, _ = debug.checked(lambda t: t * 2)(torch.ones(3))
    err.throw()
    with pytest.raises(ValueError, match="other"):
        debug.checked(lambda: (_ for _ in ()).throw(ValueError("other")))()
