"""The 3xTF32 split of K4's f32 tensor-core kernel, modelled on the CPU.

``csrc/flash_attention_sm90_f32.cu`` takes both of attention's products on
the TF32 tensor cores as hi.hi + hi.lo + lo.hi over operands split by
rna-rounding (``ref.tf32_round``).  ``ref.attention_tf32x3_plain`` models
that arithmetic; here it meets K4's f32 tolerance of 2e-5 against the JAX
package's ``repro.kernels.ref.attention_ref`` on the JAX flash sweep's
shapes, at T = 1,024 and at hd 256, while one TF32 pass on the same inputs
misses it: the split is needed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

TOL = 2e-5          # K4's f32 tolerance (tests/test_kernels.py)
# The JAX flash sweep's (B, H, T, hd), qwen1.5-0.5b's T with 4 heads, and a
# 256-wide head.
SHAPES = [(1, 1, 8, 64), (2, 4, 16, 64), (1, 2, 128, 128), (2, 2, 96, 80),
          (1, 4, 256, 112), (1, 4, 1024, 64), (1, 2, 256, 256)]


def _inputs(B, H, T, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, H, T, hd)).astype(np.float32)
            for _ in range(3)]


def _errors(B, H, T, hd):
    """max |err| against JAX's oracle of the 3xTF32 model and of one TF32
    pass on the same causal inputs."""
    q, k, v = _inputs(B, H, T, hd, T + hd)
    want = np.asarray(jref.attention_ref(*map(jnp.asarray, (q, k, v)),
                                         causal=True), np.float32)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    out = {}
    for name, mm in (("x3", ref.matmul_tf32x3), ("x1", ref.matmul_tf32)):
        got = ref.attention_tf32x3_plain(qt, kt, vt, causal=True, mm=mm)
        out[name] = float(np.abs(got.numpy() - want).max())
    return out


@pytest.mark.parametrize("B,H,T,hd", SHAPES)
def test_tf32x3_meets_the_f32_tolerance_and_one_pass_misses_it(B, H, T, hd):
    err = _errors(B, H, T, hd)
    assert err["x3"] <= TOL, err
    assert err["x1"] > TOL, err


def test_tf32_round_is_round_to_nearest_ties_away():
    """Bit by bit against integer arithmetic on the magnitude: 13 low bits
    dropped, the 10-bit mantissa rounded half away from zero (ties at
    exactly bit 12), the sign kept, infinities and NaN untouched."""
    rng = np.random.default_rng(7)
    mag = rng.integers(0, 0x7F7FE000, 20000, dtype=np.int64)
    mag[:6] = [0x3F800000, 0x3F801000, 0x3F800FFF, 0x3F803000, 0x3F802FFF,
               0x3F7FF000]          # 1.0, ties up, below a tie, ...
    sign = rng.integers(0, 2, mag.size, dtype=np.int64) << 31
    bits = (mag | sign).astype(np.uint32)
    x = bits.view(np.float32)
    want = (((mag + 0x1000) & ~0x1FFF) | sign).astype(np.uint32)
    got = ref.tf32_round(torch.from_numpy(x.copy())).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    got_mag = got & 0x7FFFFFFF
    assert got_mag[1] == 0x3F802000 and got_mag[2] == 0x3F800000
    assert got_mag[3] == 0x3F804000 and got_mag[5] == 0x3F800000
    special = torch.tensor([float("inf"), -float("inf"), float("nan"), 0.0])
    out = ref.tf32_round(special)
    assert torch.equal(out[:2], special[:2]) and torch.isnan(out[2])
    assert out[3] == 0.0


def test_tf32_split_recovers_f32_to_22_bits():
    """hi and lo are TF32 values (13 low bits clear) and hi + lo is x to
    within 2^-22 |x|; the split of a TF32 value is exact (lo = 0)."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy((rng.normal(size=4096) * 10.0 ** rng.integers(
        -20, 20, 4096)).astype(np.float32))
    hi, lo = ref.tf32_split(x)
    for t in (hi, lo):
        assert (t.view(torch.int32) & 0x1FFF == 0).all()
    err = (hi.double() + lo.double() - x.double()).abs()
    assert (err <= x.double().abs() * 2.0 ** -22).all()
    hi2, lo2 = ref.tf32_split(hi)
    assert torch.equal(hi2, hi) and (lo2 == 0).all()
