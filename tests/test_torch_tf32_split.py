"""The split arithmetic of csrc/tf32_mma.cuh (the TF32 tensor-core
contraction of the kernel modes) built for the host with g++ and held
against numpy: the round-to-nearest TF32 value, the hi / lo split, and a
dot of depth 32 in 3 passes (fp32-class) and in 1 pass (fast-math)."""

import ctypes
import os
import subprocess

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_HARNESS = r"""
#include "tf32_mma.cuh"

extern "C" float tf32_round(float x) { return dgs::tf32_round(x); }
extern "C" void tf32_split(float x, float* hi, float* lo) {
  dgs::tf32_split(x, *hi, *lo);
}
extern "C" float tf32_dot3(const float* a, const float* b, int n) {
  return dgs::tf32_dot<3>(a, b, n);
}
extern "C" float tf32_dot1(const float* a, const float* b, int n) {
  return dgs::tf32_dot<1>(a, b, n);
}
"""


@pytest.fixture(scope="module")
def tf32(tmp_path_factory):
    d = tmp_path_factory.mktemp("tf32")
    src = d / "harness.cpp"
    src.write_text(_HARNESS)
    lib = d / "harness.so"
    subprocess.run(
        ["g++", "-std=c++17", "-O2", "-shared", "-fPIC", "-I",
         os.path.join(REPO, "dgs_tpu_torch", "csrc"), "-o", str(lib),
         str(src)], check=True, capture_output=True)
    h = ctypes.CDLL(str(lib))
    f, fp = ctypes.c_float, ctypes.POINTER(ctypes.c_float)
    h.tf32_round.argtypes = [f]
    h.tf32_round.restype = f
    h.tf32_split.argtypes = [f, fp, fp]
    for name in ("tf32_dot3", "tf32_dot1"):
        getattr(h, name).argtypes = [fp, fp, ctypes.c_int]
        getattr(h, name).restype = f
    return h


def _rna_tf32(x):
    """numpy reference: x rounded to 10 explicit mantissa bits, to nearest,
    ties away from zero (exact in float64: the TF32 neighbours of an fp32
    value are fp32 values)."""
    x = np.float64(x)
    if x == 0.0 or not np.isfinite(x):
        return np.float32(x)
    m, e = np.frexp(abs(x))               # abs(x) = m 2^e, m in [0.5, 1)
    scaled = m * 2.0 ** 11                # 11 significant bits
    r = np.floor(scaled + 0.5)            # ties away from zero
    return np.float32(np.copysign(r * 2.0 ** (e - 11), x))


def _operands(rng, n):
    """fp32 values over many binades, both signs, with exact ties and
    values near the binade edges."""
    x = (rng.standard_normal(n) * 10.0 ** rng.uniform(-6, 6, n)).astype(
        np.float32)
    ties = (rng.integers(1, 2 ** 11, 64).astype(np.float64) + 0.5) * 2.0 ** \
        rng.integers(-30, 30, 64)
    edges = np.nextafter(np.float32(2.0) ** rng.integers(-20, 20, 32),
                         np.float32(0)).astype(np.float32)
    return np.concatenate([x, ties.astype(np.float32),
                           -ties.astype(np.float32), edges, [0.0, -0.0]])


def test_round_is_to_nearest_tf32(tf32):
    """hi = tf32_round(x) keeps 10 explicit mantissa bits (the low 13 bits
    of the fp32 word zero), is the nearest such value (ties away from zero,
    as cvt.rna), and passes infinities."""
    rng = np.random.default_rng(0)
    for x in _operands(rng, 4000):
        hi = np.float32(tf32.tf32_round(float(x)))
        assert hi == _rna_tf32(x), x
        assert int(hi.view(np.uint32)) & 0x1FFF == 0, x
    assert np.isinf(tf32.tf32_round(float("inf")))


def test_split_restores_x(tf32):
    """hi + lo restores x to within fp32's last bits: lo = tf32(x - hi)
    drops at most half a TF32 ulp of x - hi (2^-11 relative), so
    |x - hi - lo| <= 2^-22 |x|; both parts are TF32 values."""
    rng = np.random.default_rng(1)
    hi, lo = ctypes.c_float(), ctypes.c_float()
    for x in _operands(rng, 4000):
        tf32.tf32_split(float(x), ctypes.byref(hi), ctypes.byref(lo))
        h, l = np.float32(hi.value), np.float32(lo.value)
        assert h == _rna_tf32(x)
        assert l == _rna_tf32(np.float32(x) - h)
        assert int(l.view(np.uint32)) & 0x1FFF == 0
        err = abs(np.float64(x) - np.float64(h) - np.float64(l))
        assert err <= 2.0 ** -22 * abs(np.float64(x)), x


def test_three_pass_dot_is_fp32_class_and_one_pass_is_not(tf32):
    """Dots of depth 32 against float64: 3 passes are within 4 ulp * depth
    of the products' magnitude sum (ulp of fp32 at that sum) on every dot;
    1 pass, which keeps about 3 decimal digits, is outside that bound on
    most dots."""
    rng = np.random.default_rng(2)
    depth, fp = 32, ctypes.POINTER(ctypes.c_float)
    outside_3, outside_1 = 0, 0
    for _ in range(300):
        a = (rng.standard_normal(depth) * rng.uniform(0.1, 100.0)).astype(
            np.float32)
        b = rng.standard_normal(depth).astype(np.float32)
        ref = float(np.dot(a.astype(np.float64), b.astype(np.float64)))
        mag = float(np.abs(a.astype(np.float64) * b).sum())
        bound = 4 * depth * float(np.spacing(np.float32(mag)))
        pa, pb = a.ctypes.data_as(fp), b.ctypes.data_as(fp)
        outside_3 += abs(tf32.tf32_dot3(pa, pb, depth) - ref) > bound
        outside_1 += abs(tf32.tf32_dot1(pa, pb, depth) - ref) > bound
    assert outside_3 == 0
    assert outside_1 > 250
