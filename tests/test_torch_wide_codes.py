"""Binary codes wider than the kernels' resident layouts, on the CPU: the
port serves every width the JAX package serves.

- ``ops.hamming.hamming_topk`` (K5's path) at 54, 64 and 128 words (1,728,
  2,048 and 4,096 bits), with ``valid_count`` and ``row_mask``, against
  JAX's ``hamming_topk``: distances equal, each id at its distance.
- ``BinaryIndex(mode='packed')`` and ``TwoStageIndex(prefilter='binary',
  stage1='packed')`` (K4's path) at 1,600 and 2,048 bits against JAX's
  (their XLA twins, ``use_pallas=False``): the same top-k distances; ids
  compared through ``ops.topk.value_recall_at_k``, since tied rows may
  come in another order.
- The port's ``ShardedBinaryIndex(mode='packed')`` at 2,048 bits on four
  CPU shards against its unsharded index.
- Both plain versions at the new widths against their straightforward
  definitions in numpy: ``hamming_bucket_min_ref`` (popcount of the XOR,
  the penalty, the bucket minimum) and ``packed_scores_with_bucket_max_ref``
  (the +-1 product, the valid_count mask, the penalty, the bucket max).

Inputs come from numpy with a seed. The kernels run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phases 5 and 6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessionsimilaritysearch_tpu.index import twostage as jts
from sessionsimilaritysearch_tpu.index.binary import BinaryIndex as JaxBinaryIndex
from sessionsimilaritysearch_tpu.ops import hamming as jham
from sessionsimilaritysearch_tpu_torch.index.binary import BinaryIndex
from sessionsimilaritysearch_tpu_torch.index.sharded_binary import ShardedBinaryIndex
from sessionsimilaritysearch_tpu_torch.index.twostage import TwoStageIndex
from sessionsimilaritysearch_tpu_torch.ops import hamming, mips, packed, popcount
from sessionsimilaritysearch_tpu_torch.ops.topk import value_recall_at_k
from sessionsimilaritysearch_tpu_torch.parallel import create_mesh
from sessionsimilaritysearch_tpu_torch.weights import simhash_projection

INT32_MAX = 2**31 - 1


@pytest.fixture(autouse=True)
def _no_kernel_launch_on_cpu():
    counts = (popcount.launch_count, popcount.wgmma_launch_count, packed.launch_count,
              mips.launch_count)
    yield
    assert (popcount.launch_count, popcount.wgmma_launch_count, packed.launch_count,
            mips.launch_count) == counts


def _signs(rng, n, bits):
    return np.where(rng.random((n, bits)) < 0.5, 1.0, -1.0).astype(np.float32)


def _near(rng, codes, flips):
    """Copies of ``codes`` with ``flips`` random bits of each row flipped:
    queries whose nearest rows stand out from the random ones."""
    q = codes.copy()
    for row in q:
        row[rng.choice(q.shape[1], flips, replace=False)] *= -1
    return q


def _popcount_np(x: np.ndarray) -> np.ndarray:
    """Set bits of each int32 word."""
    return np.unpackbits(x.view(np.uint8).reshape(*x.shape, 4), axis=-1).sum(-1)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("words", [54, 64, 128])
def test_hamming_topk_matches_jax(words, masked):
    rng = np.random.default_rng(words + masked)
    c_signs = _signs(rng, 500, 32 * words)
    q_signs = np.concatenate([_near(rng, c_signs[:6], 3 * words), _signs(rng, 3, 32 * words)])
    qc, cc = jham.pack_bits_np(q_signs), jham.pack_bits_np(c_signs)
    kw, tkw = {}, {}
    if masked:
        mask = rng.random(500) < 0.8
        kw = {"valid_count": jnp.asarray(460, jnp.int32), "row_mask": jnp.asarray(mask)}
        tkw = {"valid_count": 460, "row_mask": torch.from_numpy(mask)}
    dj, _ = jham.hamming_topk(jnp.asarray(qc), jnp.asarray(cc), 12, **kw)
    d, i = hamming.hamming_topk(torch.from_numpy(qc), torch.from_numpy(cc), 12, **tkw)
    np.testing.assert_array_equal(d.numpy(), np.asarray(dj))
    true = ((q_signs > 0)[:, None, :] != (c_signs[i.numpy()] > 0)).sum(-1)
    np.testing.assert_array_equal(true, d.numpy())
    if masked:
        assert i.max() < 460 and mask[i.numpy()].all()


def _binary_pair(n_bits, rows, capacity=4096):
    j = JaxBinaryIndex(n_bits, capacity, mode="packed", use_pallas=False)
    t = BinaryIndex(n_bits, capacity, "packed", device="cpu")
    for lo, hi in ((0, 200), (200, len(rows))):
        j.add(rows[lo:hi])
        t.add(rows[lo:hi])
    return j, t


@pytest.mark.parametrize("n_bits", [1600, 2048])
def test_packed_binary_index_matches_jax(n_bits):
    rng = np.random.default_rng(n_bits)
    codes = _signs(rng, 300, n_bits)
    q = np.concatenate([_near(rng, codes[:5], n_bits // 8), _signs(rng, 3, n_bits)])
    j, t = _binary_pair(n_bits, codes)
    mask = rng.random(300) < 0.7
    for row_mask in (None, mask):
        dj, ij = j.search(q, 10, row_mask=row_mask)
        d, i = t.search(q, 10, row_mask=row_mask)
        np.testing.assert_array_equal(d, np.asarray(dj))
        # each id at its distance, and as good a set as JAX's (ties may
        # swap), over the rows the mask allows
        true = ((n_bits - np.einsum("qb,qkb->qk", q, codes[i])) / 2).astype(np.int32)
        np.testing.assert_array_equal(true, d)
        allowed = np.arange(300) if row_mask is None else np.flatnonzero(mask)
        assert np.isin(i, allowed).all()
        recalls = [value_recall_at_k(np.searchsorted(allowed, ids), q, codes[allowed], 10)
                   for ids in (i, np.asarray(ij))]
        assert recalls == [1.0, 1.0]


@pytest.mark.parametrize("n_bits", [1600, 2048])
def test_packed_twostage_index_matches_jax(n_bits):
    dim, k = 64, 10
    rng = np.random.default_rng(n_bits + 1)
    rows = rng.standard_normal((400, dim)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    q = rows[:12] + 0.3 * rng.standard_normal((12, dim)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    kw = dict(prefilter="binary", stage1="packed", pool=64, n_bits=n_bits, metric="ip")
    R = jax.random.normal(jax.random.PRNGKey(0), (dim, n_bits), jnp.float32)
    j = jts.TwoStageIndex(dim, 1024, use_pallas=False, **kw)
    t = TwoStageIndex(dim, 1024, device="cpu", projection=simhash_projection(np.asarray(R)),
                      **kw)
    j.add(rows)
    t.add(rows)
    dj, ij = j.search(q, k)
    d, i = t.search(q, k)
    np.testing.assert_allclose(d, np.asarray(dj), atol=1e-5, rtol=0)
    # each id at its score (the re-rank stores bf16 rows), and as good a
    # set as JAX's
    stored = torch.from_numpy(rows).bfloat16().float().numpy()
    np.testing.assert_allclose(np.einsum("qd,qkd->qk", q, stored[i]), d, atol=1e-5, rtol=0)
    assert (value_recall_at_k(i, q, stored, k)
            == value_recall_at_k(np.asarray(ij), q, stored, k))


def test_sharded_packed_binary_index_matches_unsharded():
    n_bits = 2048
    rng = np.random.default_rng(7)
    codes = _signs(rng, 600, n_bits)
    q = np.concatenate([_near(rng, codes[:6], 200), _signs(rng, 2, n_bits)])
    t = BinaryIndex(n_bits, 4096, "packed", device="cpu")
    sharded = ShardedBinaryIndex(n_bits, 4096, create_mesh(devices=[torch.device("cpu")] * 4),
                                 mode="packed")
    for lo, hi in ((0, 256), (256, 600)):  # batches divide over the shards
        t.add(codes[lo:hi])
        sharded.add(codes[lo:hi])
    d, i = t.search(q, 10)
    ds, is_ = sharded.search(q, 10)
    np.testing.assert_array_equal(ds, d)
    true = ((n_bits - np.einsum("qb,qkb->qk", q, codes[is_])) / 2).astype(np.int32)
    np.testing.assert_array_equal(true, ds)
    assert value_recall_at_k(is_, q, codes, 10) == value_recall_at_k(i, q, codes, 10) == 1.0


@pytest.mark.parametrize("words", [54, 64, 128])
def test_hamming_bucket_min_plain_at_wide_widths(words):
    rng = np.random.default_rng(words + 2)
    qc = rng.integers(-2**31, 2**31, (5, words)).astype(np.int32)
    cc = rng.integers(-2**31, 2**31, (300, words)).astype(np.int32)
    pen = np.where(rng.random(300) < 0.2, popcount.PENALTY, 0).astype(np.int32)
    dist = _popcount_np(qc[:, None, :] ^ cc[None, :, :]).sum(-1) + pen
    want = np.pad(dist, ((0, 0), (0, 84)), constant_values=INT32_MAX).reshape(5, 3, 128).min(-1)
    got = popcount.hamming_bucket_min_ref(torch.from_numpy(qc), torch.from_numpy(cc),
                                          torch.from_numpy(pen))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("score_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [1664, 2048, 4096])
def test_packed_scores_plain_at_wide_widths(bits, score_dtype):
    rng = np.random.default_rng(bits)
    n, vc = 4096, 3900
    rows = _signs(rng, n, bits)
    q = _signs(rng, 6, bits)
    q[:, bits - 60:] = 0  # pad columns past a 1,600-bit code (or any) are zero
    pen = np.where(rng.random(n) < 0.1, -np.inf, 0.0).astype(np.float32)
    s = q.astype(np.float64) @ rows.astype(np.float64).T
    s[:, vc:] = -np.inf
    s += pen
    words = torch.from_numpy(hamming.pack_bits_t_np(rows))
    got_s, got_b = packed.packed_scores_with_bucket_max_ref(
        torch.from_numpy(q).bfloat16(), words, vc, torch.from_numpy(pen), score_dtype)
    np.testing.assert_array_equal(got_b.numpy(), s.reshape(6, n // 128, 128).max(-1))
    want = torch.from_numpy(s.astype(np.float32)).to(score_dtype)
    assert torch.equal(got_s, want)
