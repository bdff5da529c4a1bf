"""K5's variant choice and the arithmetic of its wgmma variant, on the CPU.

- ``popcount.k5_variant``: the plain version for CPU tensors; on CUDA the
  wgmma variant (``csrc/hamming_bucket_min_sm90.cu``) for 16-byte-aligned
  bases, popc (``csrc/hamming_bucket_min.cu``) for the others, at every
  width of at least 1 word (54 words and wider too: the op holds no width
  limit); a width of 0 words and a device other than the CPU or CUDA
  raise.
- The identity the wgmma variant computes by: over the 32 W bits of W words,
  bit 1 -> +1 and bit 0 -> -1 as s8, (32 W - <a, b>) / 2 is the Hamming
  distance, pad bits included, held against JAX's XLA
  ``ops.hamming.hamming_topk``; the kernel's nibble unpack bit for bit; its
  penalty epilogue, (16 W + penalty) - <a, b> / 2 with int32 wrapping,
  against the plain version.
- The plain version and ``hamming_topk`` against JAX's at W = 1 and 53.

Inputs come from numpy with a seed. The kernels run only on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessionsimilaritysearch_tpu.ops import hamming as jham
from sessionsimilaritysearch_tpu_torch.ops import _build, hamming, popcount

# code widths in bits -> 1, 3, 8, 13 and 53 words, each with pad bits but the last
WIDTHS = (20, 90, 250, 400, 1696)


@pytest.fixture(autouse=True)
def _no_kernel_launch_on_cpu():
    counts = (popcount.launch_count, popcount.wgmma_launch_count)
    yield
    assert (popcount.launch_count, popcount.wgmma_launch_count) == counts


def _codes(rng, rows, bits):
    signs = np.where(rng.random((rows, bits)) < 0.5, 1.0, -1.0).astype(np.float32)
    return signs, jham.pack_bits_np(signs)


def _pm1(words: np.ndarray) -> np.ndarray:
    """[n, W] int32 -> [n, 32 W] int8: bit j of word w -> column 32 w + j,
    +1 for a set bit, -1 for a clear one (the wgmma variant's operands)."""
    bits = (words.view(np.uint32)[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    return np.where(bits.reshape(len(words), -1) > 0, 1, -1).astype(np.int8)


def _kernel_unpack(word: int) -> np.ndarray:
    """The 32 s8 bytes the kernel's store_unpacked writes for one word: for
    g = 0..7, the word prmt's sign replication makes of w << (7 - g) (each
    byte 0xFF where its top bit is set), OR 0x01010101; little-endian."""
    out = []
    for g in range(8):
        y = (word << (7 - g)) & 0xFFFFFFFF
        r = sum(0xFF << (8 * k) for k in range(4) if (y >> (8 * k + 7)) & 1)
        out.append(r | 0x01010101)
    return np.array(out, dtype="<u4").view(np.int8)


# value 4 g + k of a word's 32 in the kernel's order is bit g + 8 k
KERNEL_ORDER = np.array([g + 8 * k for g in range(8) for k in range(4)])


@pytest.mark.parametrize("device,words,aligned,want", [
    ("cpu", 8, True, "plain"),
    ("cpu", 8, False, "plain"),
    ("cpu", 53, True, "plain"),
    ("cuda", 1, True, "wgmma"),
    ("cuda", 8, True, "wgmma"),
    ("cuda", 53, True, "wgmma"),
    ("cuda", 1, False, "popc"),
    ("cuda", 8, False, "popc"),
    ("cuda", 53, False, "popc"),
    ("cuda", 54, True, "wgmma"),
    ("cpu", 54, True, "plain"),
])
def test_k5_variant(device, words, aligned, want):
    assert popcount.k5_variant(device, words, aligned) == want


@pytest.mark.parametrize("device,words", [("cuda", 0), ("cpu", 0), ("mps", 8)])
def test_k5_variant_raises(device, words):
    with pytest.raises(ValueError):
        popcount.k5_variant(device, words, True)


@pytest.mark.parametrize("start,pen_start,aligned", [
    (0, None, True),   # whole tensors: 16-byte-aligned bases
    (4, None, True),   # 4 rows of 3 words: 48 bytes on
    (5, None, False),  # 5 rows of 3 words: 60 bytes on
    (0, 0, True),
    (0, 1, False),     # a penalty view 4 bytes on
])
def test_wrapper_reads_alignment_from_every_base(monkeypatch, start, pen_start, aligned):
    seen = []
    choose = popcount.k5_variant
    monkeypatch.setattr(popcount, "k5_variant",
                        lambda d, w, a: seen.append((d, w, a)) or choose(d, w, a))
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.integers(-2**31, 2**31, (7, 3)).astype(np.int32))
    c_all = torch.tensor(rng.integers(-2**31, 2**31, (300, 3)).astype(np.int32))
    c = c_all[start:start + 290]
    pen = None
    if pen_start is not None:
        pen = torch.zeros(300, dtype=torch.int32)[pen_start:pen_start + 290]
    got = popcount.hamming_bucket_min(q, c, pen)
    assert seen == [("cpu", 3, aligned)]
    assert torch.equal(got, popcount.hamming_bucket_min_ref(q, c, pen))


def test_kernel_unpack_is_the_negated_sign_unpack_in_its_order():
    rng = np.random.default_rng(1)
    words = np.concatenate([rng.integers(-2**31, 2**31, 500),
                            [0, -1, -2**31, 2**31 - 1, 0x55555555, -0x55555556]])
    words = words.astype(np.int32)
    want = _pm1(words[:, None])
    got = np.stack([_kernel_unpack(int(w) & 0xFFFFFFFF) for w in words])
    # a set bit is -1 and a clear one +1: both operands negated, in the
    # kernel's order
    np.testing.assert_array_equal(got, -want[:, KERNEL_ORDER])
    # one order and one sign for queries and rows: the dots are those of the
    # bit order
    np.testing.assert_array_equal(got.astype(np.int32) @ got[:50].astype(np.int32).T,
                                  want.astype(np.int32) @ want[:50].astype(np.int32).T)


@pytest.mark.parametrize("bits", WIDTHS)
def test_pm1_identity_equals_xla_hamming(bits):
    rng = np.random.default_rng(bits)
    _, qc = _codes(rng, 9, bits)
    _, cc = _codes(rng, 70, bits)
    w = qc.shape[1]
    dot = _pm1(qc).astype(np.int32) @ _pm1(cc).astype(np.int32).T
    dist = (32 * w - dot) >> 1
    d, i = jham.hamming_topk(jnp.asarray(qc), jnp.asarray(cc), len(cc))
    want = np.empty_like(dist)
    np.put_along_axis(want, np.asarray(i), np.asarray(d), axis=1)
    np.testing.assert_array_equal(dist, want)
    np.testing.assert_array_equal(
        dist, popcount.hamming_distances(torch.from_numpy(qc)[:, None, :],
                                         torch.from_numpy(cc)[None, :, :]).numpy())


@pytest.mark.parametrize("bits", (20, 400, 1696))
def test_penalty_epilogue_equals_plain(bits):
    # the wgmma variant's epilogue: min over a bucket's rows of
    # (16 W + penalty) - dot / 2, in int32 arithmetic that wraps
    rng = np.random.default_rng(bits + 1)
    _, qc = _codes(rng, 5, bits)
    _, cc = _codes(rng, 300, bits)
    w = qc.shape[1]
    pen = rng.integers(-2**31, 2**31, 300).astype(np.int32)
    pen[:3] = [2**31 - 1, -2**31, popcount.PENALTY]
    dot = _pm1(qc).astype(np.int64) @ _pm1(cc).astype(np.int64).T
    p = (16 * w + pen.astype(np.int64)).astype(np.int32)  # wraps
    val = (p.astype(np.int64) - (dot >> 1)).astype(np.int32)  # wraps
    val = np.pad(val, ((0, 0), (0, 84)), constant_values=2**31 - 1)
    bmin = val.reshape(5, 3, 128).min(-1)
    got = popcount.hamming_bucket_min_ref(torch.from_numpy(qc), torch.from_numpy(cc),
                                          torch.from_numpy(pen))
    np.testing.assert_array_equal(got.numpy(), bmin)


@pytest.mark.parametrize("bits", (20, 1696))
@pytest.mark.parametrize("masked", (False, True))
def test_plain_topk_matches_jax(bits, masked):
    rng = np.random.default_rng(bits + masked)
    q_signs, qc = _codes(rng, 11, bits)
    c_signs, cc = _codes(rng, 700, bits)
    kw, tkw = {}, {}
    if masked:
        mask = rng.random(700) < 0.8
        kw = {"valid_count": jnp.asarray(650, jnp.int32), "row_mask": jnp.asarray(mask)}
        tkw = {"valid_count": 650, "row_mask": torch.from_numpy(mask)}
    dj, _ = jham.hamming_topk(jnp.asarray(qc), jnp.asarray(cc), 20, **kw)
    d, i = hamming.hamming_topk(torch.from_numpy(qc), torch.from_numpy(cc), 20, **tkw)
    np.testing.assert_array_equal(np.sort(d.numpy(), 1), np.sort(np.asarray(dj), 1))
    true = ((q_signs > 0)[:, None, :] != (c_signs[i.numpy()] > 0)).sum(-1)
    np.testing.assert_array_equal(true, d.numpy())
    if masked:
        assert i.max() < 650 and mask[i.numpy()].all()


def test_build_reports_serialized_wgmma():
    # ptxas' note when a wgmma sits on a path it cannot prove warpgroup-
    # uniform; chip_smoke.py refuses a build that has one
    out = """ptxas info    : (C7518) Potential Performance Loss: wgmma.mma_async instructions are serialized due to program dependence on compiler-inserted WG.DP in divergent path in the function '_Z1kv'
ptxas info    : Function properties for _Z1kv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers"""
    info = _build.parse_ptxas(out)
    assert info["spills"] == {"_Z1kv": 0}
    assert len(info["perf_notes"]) == 1 and "serialized" in info["perf_notes"][0]
    assert _build.parse_ptxas(out.split("\n", 1)[1])["perf_notes"] == []
