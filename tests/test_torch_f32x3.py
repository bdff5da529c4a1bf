"""The 3xTF32 split of the port's f32 Hopper kernel
(``sessionsimilaritysearch_tpu_torch/csrc/scores_bmax_f32_sm90.cu``, K1's and
K6's variant for f32 rows), emulated on the CPU in torch bit operations.

Each operand x splits into big (x with its low 13 bits cleared: what the
tensor core reads of an f32 word) and small (x - big, rounded to tf32 by
adding half a tf32 ulp to the magnitude and clearing the low 13 bits); the
kernel sums a_small * b_big + a_big * b_small + a_big * b_big and drops
small * small. These tests guard the design, not the code: they run a
Python copy of the split (the rule ``tf32_small`` in csrc/sm90_common.cuh
states), and show that its parts are tf32 values and that the three-term
product stays within twice the plain f32 matmul's largest error against the
f64 product, the gate ``chip_smoke.py`` holds the kernel to on the card. A
change to the CUDA code does not reach them: the kernel's arithmetic is held
to that gate and to its plain version by the card tests of
tests/test_torch_cuda.py (``test_f32_wgmma_accuracy_within_twice_sgemm``
among them) and by chip_smoke.py."""

import numpy as np
import pytest
import torch

LOW13 = -0x2000  # int32 0xffffe000: clears the 13 bits tf32 does not keep
BK = 32  # the kernel's K slice: one wgmma chain, then a round-to-nearest add


def big(x: torch.Tensor) -> torch.Tensor:
    return (x.view(torch.int32) & LOW13).view(torch.float32)


def small(x: torch.Tensor) -> torch.Tensor:
    r = x - big(x)  # exact: the low 13 bits of x
    return ((r.view(torch.int32) + 0x1000) & LOW13).view(torch.float32)


def rows(seed: int, n: int, d: int, unit: bool) -> torch.Tensor:
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    if unit:
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    return torch.from_numpy(x)


def three_term(a: torch.Tensor, b: torch.Tensor, acc: str) -> torch.Tensor:
    """The kernel's product of a [q, d] and b [n, d] from their parts:
    'f64' sums exactly enough to show the split alone; 'f32' as the kernel
    orders it, in f32 (small terms first within a K slice, then the big
    one, the slices summed with round-to-nearest adds)."""
    ab, asm, bb, bsm = big(a), small(a), big(b), small(b)
    if acc == "f64":
        ab, asm, bb, bsm = (x.double() for x in (ab, asm, bb, bsm))
        return asm @ bb.T + ab @ bsm.T + ab @ bb.T
    total = torch.zeros(a.shape[0], b.shape[0])
    for k in range(0, a.shape[1], BK):
        sl = slice(k, k + BK)
        part = asm[:, sl] @ bb[:, sl].T + ab[:, sl] @ bsm[:, sl].T
        total = total + (part + ab[:, sl] @ bb[:, sl].T)
    return total


@pytest.fixture(scope="module")
def values():
    # normal values over a wide range of exponents, signs and zeros
    rng = np.random.default_rng(0)
    x = rng.standard_normal(1 << 16) * np.exp2(rng.integers(-60, 60, 1 << 16))
    x[:64] = 0.0
    return torch.from_numpy(x.astype(np.float32))


def test_parts_are_tf32_and_the_rest_is_tiny(values):
    x = values
    b, s = big(x), small(x)
    assert not (b.view(torch.int32) & 0x1FFF).any()
    assert not (s.view(torch.int32) & 0x1FFF).any()
    xd, bd, sd = x.double(), b.double(), s.double()
    # big keeps x's top bits (toward zero), small is within half a tf32 ulp
    # of x - big, and what is left is below 2^-21 |x|
    assert ((bd.abs() <= xd.abs()) & (bd * xd >= 0)).all()
    assert ((xd - bd).abs() < 2.0**-10 * xd.abs() + (xd == 0)).all()
    assert ((xd - bd - sd).abs() <= 2.0**-11 * (xd - bd).abs()).all()
    assert ((xd - bd - sd).abs() <= 2.0**-21 * xd.abs()).all()
    assert torch.equal(b[:64], torch.zeros(64)) and torch.equal(s[:64], torch.zeros(64))


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_small_rounds_half_away_from_zero(sign):
    # x - big has 13 significant bits, 2 more than tf32 keeps: low bits
    # 0x1002 (binary 1 0000000000 10) are a tie and round up in magnitude,
    # 0x1001 rounds down
    one = torch.tensor([sign * (1.0 + 2.0**-10)], dtype=torch.float32)  # a tf32 value
    ulp = 2.0**-23  # of x's exponent

    def with_low_bits(bits):
        return (one.view(torch.int32) | bits).view(torch.float32)

    assert small(with_low_bits(0x1002)).item() == sign * 0x1004 * ulp
    assert small(with_low_bits(0x1001)).item() == sign * 0x1000 * ulp
    assert small(with_low_bits(0x1003)).item() == sign * 0x1004 * ulp


@pytest.mark.parametrize("acc", ["f64", "f32"])
@pytest.mark.parametrize("d,unit", [(1600, True), (200, False)])
def test_three_terms_within_twice_the_f32_matmul(d, unit, acc):
    # seeded unit rows at d = 1600 (the engine's width) and standard-normal
    # rows at d = 200, as the card's gate takes them
    a, b = rows(1, 64, d, unit), rows(2, 4096, d, unit)
    exact = a.double() @ b.double().T
    err_f32 = (a @ b.T - exact).abs().max().item()
    err = (three_term(a, b, acc).double() - exact).abs().max().item()
    assert err <= 2 * err_f32, (err, err_f32)


@pytest.mark.parametrize("d,unit", [(1600, True), (200, False)])
def test_one_pass_misses_the_gate(d, unit):
    # big x big alone is a TF32 product: far outside the gate, which is why
    # the f32 kernels never run it on its own
    a, b = rows(3, 64, d, unit), rows(4, 4096, d, unit)
    exact = a.double() @ b.double().T
    err_f32 = (a @ b.T - exact).abs().max().item()
    err = (big(a).double() @ big(b).double().T - exact).abs().max().item()
    assert err > 100 * err_f32


def test_zero_filled_tail_adds_nothing():
    # TMA zero-fills depth past d: zeros split into zeros, so a d = 36 row
    # padded to two 32-deep slices scores as the unpadded one
    a, b = rows(5, 8, 36, False), rows(6, 300, 36, False)
    pad = torch.nn.functional.pad
    torch.testing.assert_close(three_term(pad(a, (0, 28)), pad(b, (0, 28)), "f64"),
                               three_term(a, b, "f64"), atol=0, rtol=0)
