"""Time four mode kernels against variant builds of their sources, on the
card, on one set of operands.

    python3 chip_variants.py [VARIANT_DIR ...]

Each VARIANT_DIR holds one edited copy of dgs_tpu_torch/csrc/
tiled_forward_sep.cu, tiled_backward_hmm.cu, tiled_backward_folded.cu or
tiled_backward_moments.cu (headers it includes are taken from the
directory first, then from csrc/: an older tree's source with its own
headers is a variant too).  The script builds the package's library
(kernels/_build.py) and each variant with nvcc into its own shared
library, prints the ptxas registers and spills of their D = 2-3
three-order instantiations and every instantiation that spills, then
times with CUDA events (chip_smoke.cuda_ms) on tools.bench's D = 3 chunked
workload and its D = 2 headline, for each kernel that a variant edits (all
four without a variant): the separable forward on the operands of
BENCH_SEP=1 BENCH_MOMENTS=1 at 3 and 1 TF32 passes beside kernel 1, and at
D = 3 against its plain version; h_matmul on those of BENCH_HMM=1 at 3 and
1 passes beside kernel 2 on the same cotangent, and at D = 3 against the
plain backward; the folded dvalues on those of BENCH_FOLDED=1 BENCH_FDV=1
(D = 3) and + BENCH_FVJP=1 (D = 2), at 3 and 1 passes; the moment form on
those of BENCH_SEP=1 BENCH_MOMENTS=1 beside kernel 2.  Each variant's
output against the library's (max |diff| / max |ref|).  One JSON line a
kernel and D.  Needs one card.
"""

import ctypes
import glob
import json
import os
import re
import subprocess
import sys

import torch

import chip_smoke as c
from dgs_tpu_torch.kernels import _build, tiled as kt
from dgs_tpu_torch.ops import formulas


def build_variants(dirs):
    """Start nvcc on each variant directory's source; the package's
    library is built meanwhile.  Returns {name: (kind, ctypes library)} of
    the variants that built (a failed build is printed and left out)."""
    arch = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]
    csrc = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "dgs_tpu_torch", "csrc")
    procs = {}
    for d in dirs:
        src = glob.glob(os.path.join(d, "*.cu"))[0]
        procs[d] = subprocess.Popen(
            [_build.nvcc()] + arch + ["-Xcompiler", "-fPIC", "-Xptxas", "-v",
                                      "-shared", "-I", d, "-I", csrc, "-o",
                                      os.path.join(d, "lib.so"), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    c.phase_build()
    report(_build.build_log(), "library")
    ref = _build.load()
    libs = {}
    for d, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:   # reported and left out: the others still run
            print(json.dumps({"nvcc_failed": d, "log": out[-3000:]}),
                  flush=True)
            continue
        report(out, d)
        lib = ctypes.CDLL(os.path.abspath(os.path.join(d, "lib.so")))
        libs[d] = (bind(lib, ref, d), lib)
    return libs


ENTRIES = {"fdv": "dgs_tiled_backward_fdv",
           "moments": "dgs_tiled_backward_moments",
           "sep": "dgs_tiled_forward_sep",
           "hmm": "dgs_tiled_backward_hmm"}
KERNELS = ("fdv_kernel", "moments_kernel", "sep_kernel", "hmm_kernel",
           "tiled_backward_kernel")


def bind(lib, ref, name):
    """The kind ("fdv" or "moments") of the variant library ``lib``, whose
    C entry takes the argument and result types that the package's library
    ``ref`` (kernels/_build.py load) gives the same entry."""
    for kind, entry in ENTRIES.items():
        if hasattr(lib, entry):
            fn, like = getattr(lib, entry), getattr(ref, entry)
            fn.argtypes, fn.restype = like.argtypes, like.restype
            return kind
    raise RuntimeError(f"{name}: exports none of {sorted(ENTRIES.values())}")


def report(log, tag):
    """ptxas registers and spills of the mode kernels' three-order
    instantiations at D = 2 and 3, and every instantiation of them that
    spills."""
    spilling = {}
    for r in log.split("Compiling entry function")[1:]:
        n = r.split("'")[1]
        if not any(k in n for k in KERNELS):
            continue
        spill = sum(map(int, re.findall(r"(\d+) bytes spill stores", r)))
        if spill:
            spilling[re.sub(r"^_ZN\S*?\d+(?=[a-z_]+_kernelI)", "",
                            n)[:60]] = spill
        if re.search(r"ILi[23]ELi7E", n):
            print(json.dumps({
                "ptxas": tag,
                "kernel": re.sub(r"^_ZN\S*?\d+(?=[a-z_]+_kernelI)", "",
                                 n)[:60],
                "registers": re.findall(r"Used (\d+) registers", r),
                "spill_bytes": re.findall(r"(\d+) bytes spill stores", r)}),
                flush=True)
    print(json.dumps({"ptxas": tag, "spilling": spilling}), flush=True)


def cotangent(ev, packed):
    """The bench loss's cotangent of the packed outputs."""
    N = ev["state"].s_perm.shape[0]
    w = torch.cat([torch.tensor(formulas.sym_multiplicity(o, ev["D"]),
                                dtype=torch.float32, device=packed.device
                                ).repeat_interleave(ev["C"])
                   for o in ev["orders"]])
    return (2.0 / N) * w[:, None] * packed


def rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def evaluation(dev, env, D):
    """The workload's tiled evaluation (chip_smoke.tiled_evaluations)."""
    _, w = c.modes_workload(dev, env, D=D)
    value, _ = c.bench.loss(w)
    (ev,) = c.tiled_evaluations(value)
    return ev


def stream():
    return torch.cuda.current_stream().cuda_stream


def timed(out, name, run, got, ref):
    """Launch a variant's ``run`` once, check it, time it into out[name]
    and its result against ``ref`` into out[name + "_rel_diff"]."""
    if run() != 0:
        raise RuntimeError(f"{name}: launch failed")
    torch.cuda.synchronize()
    out[name] = c.cuda_ms(run)
    out[name + "_rel_diff"] = rel(got, ref)


def fdv_numbers(dev, libs, D):
    env = {"BENCH_FOLDED": "1", "BENCH_FDV": "1"}
    if D == 2:
        env["BENCH_FVJP"] = "1"
    ev = evaluation(dev, env, D)
    orders, C, geom, smp = ev["orders"], ev["C"], ev["geom"], ev["smp"]
    lo, n = kt.entry_ranges(ev["state"], smp.shape[1])
    s_lo, s_n = kt.sample_ranges(ev["state"], geom.shape[1])
    with torch.no_grad():
        ct = cotangent(ev, kt.tiled_forward_folded(
            orders, D, C, geom, ev["fold"], smp, lo, n))
        meta, _, R, Rp = kt.folded_layout(orders, D, C)
        cb = kt.ct_beta_rows(meta, C, ct, smp)
        local = kt.local_samples(smp, D)
        call = lambda p=3: kt.tiled_backward_fdv(
            orders, D, C, geom, local, ct, cb, s_lo, s_n, passes=p)
        ref = call()
        out = {"kernel": "tiled_backward_fdv", "D": D,
               "library": c.cuda_ms(call),
               "library_one_pass": c.cuda_ms(lambda: call(1))}
        mask, rows = kt._order_rows(orders, D)
        Ep, Np = geom.shape[1], local.shape[1]
        for name, (kind, lib) in libs.items():
            if kind != "fdv":
                continue
            got = torch.empty((Ep, ref.shape[0]), device=dev)
            timed(out, name, lambda lib=lib, got=got: lib.dgs_tiled_backward_fdv(
                geom.data_ptr(), Ep, C, local.data_ptr(), Np, ct.data_ptr(),
                cb.data_ptr(), Rp, R, s_lo.data_ptr(), s_n.data_ptr(),
                Ep // kt.BLOCK_E, D, mask, rows["value"], rows["derivative"],
                rows["laplacian"], rows["third"], 3, 0, got.data_ptr(),
                stream()), got.T, ref)
    return out


def moments_numbers(dev, libs, D):
    ev = evaluation(dev, {"BENCH_SEP": "1", "BENCH_MOMENTS": "1"}, D)
    orders, C, geom, smp = ev["orders"], ev["C"], ev["geom"], ev["smp"]
    lo, n = kt.entry_ranges(ev["state"], smp.shape[1])
    s_lo, s_n = kt.sample_ranges(ev["state"], geom.shape[1])
    with torch.no_grad():
        base, local = kt.base_rows(geom, D, C), kt.local_samples(smp, D)
        ct = cotangent(ev, kt.tiled_forward(orders, None, D, C, base, local,
                                            lo, n))
        call = lambda: kt.tiled_backward_moments(orders, D, C, geom, smp, ct,
                                                 s_lo, s_n)
        ref = call()
        out = {"kernel": "tiled_backward_moments", "D": D,
               "library": c.cuda_ms(call),
               "kernel_2": c.cuda_ms(lambda: kt.tiled_backward(
                   orders, None, D, C, base, local, ct, s_lo, s_n))}
        mask, rows = kt._order_rows(orders, D)
        Ep, Np = geom.shape[1], smp.shape[1]
        for name, (kind, lib) in libs.items():
            if kind != "moments":
                continue
            got = torch.empty((Ep, ref.shape[0]), device=dev)
            timed(out, name,
                  lambda lib=lib, got=got: lib.dgs_tiled_backward_moments(
                      geom.data_ptr(), Ep, C, smp.data_ptr(), Np,
                      ct.data_ptr(), s_lo.data_ptr(), s_n.data_ptr(),
                      Ep // kt.BLOCK_E, D, mask, rows["value"],
                      rows["derivative"], rows["laplacian"], rows["third"],
                      got.data_ptr(), stream()), got.T, ref)
    return out


def sep_numbers(dev, libs, D):
    ev = evaluation(dev, {"BENCH_SEP": "1", "BENCH_MOMENTS": "1"}, D)
    orders, C, geom, smp = ev["orders"], ev["C"], ev["geom"], ev["smp"]
    Np = smp.shape[1]
    lo, n = kt.entry_ranges(ev["state"], Np)
    with torch.no_grad():
        call = lambda p=3: kt.tiled_forward_sep(orders, D, C, geom, smp, lo,
                                                n, passes=p)
        ref, one = call(), call(1)
        base, local = kt.base_rows(geom, D, C), kt.local_samples(smp, D)
        out = {"kernel": "tiled_forward_sep", "D": D,
               "library": c.cuda_ms(call),
               "library_one_pass": c.cuda_ms(lambda: call(1)),
               "kernel_1": c.cuda_ms(lambda: kt.tiled_forward(
                   orders, None, D, C, base, local, lo, n)),
               "one_pass_vs_three_pass": rel(one, ref)}
        if D == 3:
            out["vs_plain"] = c.err_fields(c.compare(
                ref, kt.tiled_forward_sep_plain(orders, D, C, geom, smp, lo,
                                                n), orders, D, C))
        mask, rows = kt._order_rows(orders, D)
        for name, (kind, lib) in libs.items():
            if kind != "sep":
                continue
            for p, want in ((3, ref), (1, one)):
                got = torch.empty_like(ref)
                timed(out, f"{name}_p{p}",
                      lambda lib=lib, got=got, p=p: lib.dgs_tiled_forward_sep(
                          geom.data_ptr(), geom.shape[1], C, smp.data_ptr(),
                          Np, lo.data_ptr(), n.data_ptr(), Np // kt.BLOCK_N,
                          D, mask, p, rows["value"], rows["derivative"],
                          rows["laplacian"], rows["third"], got.data_ptr(),
                          stream()), got, want)
    return out


def hmm_numbers(dev, libs, D):
    ev = evaluation(dev, {"BENCH_HMM": "1"}, D)
    orders, C, geom, smp = ev["orders"], ev["C"], ev["geom"], ev["smp"]
    period = ev["period"]
    lo, n = kt.entry_ranges(ev["state"], smp.shape[1])
    s_lo, s_n = kt.sample_ranges(ev["state"], geom.shape[1])
    with torch.no_grad():
        ct = cotangent(ev, kt.tiled_forward(orders, period, D, C, geom, smp,
                                            lo, n))
        call = lambda p=3: kt.tiled_backward_hmm(orders, period, D, C, geom,
                                                 smp, ct, s_lo, s_n,
                                                 passes=p)
        ref, one = call(), call(1)
        out = {"kernel": "tiled_backward_hmm", "D": D,
               "period": period, "library": c.cuda_ms(call),
               "library_one_pass": c.cuda_ms(lambda: call(1)),
               "kernel_2": c.cuda_ms(lambda: kt.tiled_backward(
                   orders, period, D, C, geom, smp, ct, s_lo, s_n)),
               "one_pass_vs_three_pass": rel(one, ref)}
        if D == 3:
            out["vs_plain"] = c.err_fields(c.compare_rows(
                ref, kt.tiled_backward_plain(orders, period, D, C, geom, smp,
                                             ct, s_lo, s_n), D, C))
        mask, rows = kt._order_rows(orders, D)
        Ep, Np = geom.shape[1], smp.shape[1]
        for name, (kind, lib) in libs.items():
            if kind != "hmm":
                continue
            for p, want in ((3, ref), (1, one)):
                got = torch.empty((Ep, ref.shape[0]), device=dev)
                timed(out, f"{name}_p{p}",
                      lambda lib=lib, got=got, p=p: lib.dgs_tiled_backward_hmm(
                          geom.data_ptr(), Ep, C, smp.data_ptr(), Np,
                          ct.data_ptr(), s_lo.data_ptr(), s_n.data_ptr(),
                          Ep // kt.BLOCK_E, D, mask, int(period is not None),
                          0.0 if period is None else float(period),
                          rows["value"], rows["derivative"],
                          rows["laplacian"], rows["third"], p,
                          got.data_ptr(), stream()), got.T, want)
    return out


SECTIONS = {"sep": sep_numbers, "hmm": hmm_numbers, "fdv": fdv_numbers,
            "moments": moments_numbers}


def main(dirs):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c.phase_device()
    dev = torch.device("cuda", 0)
    libs = build_variants(dirs)
    kinds = {kind for kind, _ in libs.values()} or set(SECTIONS)
    for D in (3, 2):
        for kind, section in SECTIONS.items():
            if kind in kinds:
                print(json.dumps(section(dev, libs, D)), flush=True)
                torch.cuda.empty_cache()


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("chip_variants.py: no CUDA device")
    main(sys.argv[1:])
