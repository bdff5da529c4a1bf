"""Card-only tests of the PyTorch port: the CUDA kernels (K1 scores_bmax
and its Hopper variants scores_bmax_sm90 for bf16, TMA- or cp.async-fed,
and scores_bmax_f32_sm90 for f32, K2 scores_bmax_int8 and its Hopper variant scores_bmax_int8_sm90,
K3 bucket_max, K4 packed_scores_bmax, K5 hamming_bucket_min and its
wgmma variant hamming_bucket_min_sm90, K6
scores_matmul and its Hopper variants) against their
plain PyTorch versions, and the indexes and engine on the card against the
CPU: among them DenseIndex's l2 search through K1's penalty, remove_ids,
a snapshot round trip, and the flagship serving path (bf16 serving
parameters, catalog tables, the cached forward in a default engine).

Every test here carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is False. The file imports no JAX, so on a
machine with a card and no JAX it runs without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import sessionsimilaritysearch_tpu_torch as port
from sessionsimilaritysearch_tpu_torch.index.binary import BinaryIndex
from sessionsimilaritysearch_tpu_torch.index.dense import DenseIndex, compaction_plan
from sessionsimilaritysearch_tpu_torch.index.twostage import TwoStageIndex
from sessionsimilaritysearch_tpu_torch.ops import hamming, mips, mips_int8, packed, popcount

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    # decided inside the fixture, never at import: every xdist worker then
    # collects the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [200, 37])  # 37: no 16-byte rows, scalar loads
def test_kernel_matches_plain(dev, dtype, d):
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(37, d, device=dev, generator=g).to(dtype)
    c = torch.randn(5003, d, device=dev, generator=g).to(dtype)
    pen = torch.where(torch.rand(5003, device=dev, generator=g) < 0.1,
                      float("-inf"), 0.0)
    before = mips.launch_count
    s, bmax = mips.scores_with_bucket_max(q, c, 4037, pen, dtype)
    torch.cuda.synchronize()
    assert mips.launch_count == before + 1
    s_ref, bmax_ref = mips.scores_with_bucket_max_ref(q, c, 4037, pen, dtype)
    # f32: another summation order. bf16 scores: both sides round the f32
    # value to nearest even, so they differ by at most one ulp (2^-7 rel)
    torch.testing.assert_close(bmax, bmax_ref, atol=1e-3, rtol=1e-5)
    rtol = 1e-5 if dtype == torch.float32 else 2.0**-7
    torch.testing.assert_close(s.float(), s_ref.float(), atol=1e-3, rtol=rtol)


@pytest.mark.parametrize("score_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [200, 1600])
def test_wgmma_kernel_matches_plain(dev, d, score_dtype):
    # K1's Hopper variant: ragged q and n, valid_count mid-bucket, 10% of
    # rows penalised
    g = torch.Generator(device=dev).manual_seed(6)
    q = torch.randn(37, d, device=dev, generator=g).bfloat16()
    c = torch.randn(5003, d, device=dev, generator=g).bfloat16()
    pen = torch.where(torch.rand(5003, device=dev, generator=g) < 0.1,
                      float("-inf"), 0.0)
    assert mips.k1_variant(dev.type, q.dtype, d, (q.data_ptr(), c.data_ptr())) == "wgmma"
    before, before_w = mips.launch_count, mips.wgmma_launch_count
    s, bmax = mips.scores_with_bucket_max(q, c, 4037, pen, score_dtype)
    torch.cuda.synchronize()
    assert (mips.launch_count, mips.wgmma_launch_count) == (before + 1, before_w + 1)
    s_ref, bmax_ref = mips.scores_with_bucket_max_ref(q, c, 4037, pen, score_dtype)
    assert torch.equal(torch.isneginf(s), torch.isneginf(s_ref))
    # f32 sums of exact bf16 products in another order (|s| ~ sqrt(d));
    # bf16 scores: both sides round the f32 value, one ulp apart at most
    torch.testing.assert_close(bmax, bmax_ref, atol=1e-3, rtol=1e-5)
    rtol = 1e-5 if score_dtype == torch.float32 else 2.0**-7
    torch.testing.assert_close(s.float(), s_ref.float(), atol=1e-3, rtol=rtol)


@pytest.mark.parametrize("d", [37, 250])
def test_rows_tma_cannot_take_run_the_tile_variant(dev, d):
    # bf16 rows that are no TMA stride: odd d runs the tile loop, even d
    # (the 250-bit sign codes) the cp.async-fed wgmma kernel
    g = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn(37, d, device=dev, generator=g).bfloat16()
    c = torch.randn(5003, d, device=dev, generator=g).bfloat16()
    variant = mips.k1_variant(dev.type, q.dtype, d, (q.data_ptr(), c.data_ptr()))
    assert variant == {37: "tile", 250: "cp_async"}[d]
    before = (mips.launch_count, mips.wgmma_launch_count, mips.cp_async_launch_count)
    s, bmax = mips.scores_with_bucket_max(q, c, 4037, None, torch.bfloat16)
    torch.cuda.synchronize()
    assert (mips.launch_count, mips.wgmma_launch_count, mips.cp_async_launch_count) == (
        before[0] + 1, before[1], before[2] + (variant == "cp_async"))
    s_ref, bmax_ref = mips.scores_with_bucket_max_ref(q, c, 4037, None, torch.bfloat16)
    torch.testing.assert_close(bmax, bmax_ref, atol=1e-3, rtol=1e-5)
    torch.testing.assert_close(s.float(), s_ref.float(), atol=1e-3, rtol=2.0**-7)


def _bf16_rows(g, rows, d, dev, signs, offset=0):
    """[rows, d] bf16, standard normal or +-1; `offset` elements into its
    allocation (2 elements: a base 4 bytes off 16-byte alignment)."""
    x = torch.randn(rows * d + offset, device=dev, generator=g)
    if signs:
        x = torch.where(x < 0, -1.0, 1.0)
    return x.bfloat16()[offset:].view(rows, d)


@pytest.mark.parametrize("signs", [False, True])
@pytest.mark.parametrize("score_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,offset", [(2, 0), (130, 0), (202, 0), (250, 0), (1600, 2)])
def test_cp_async_kernel_matches_plain(dev, d, offset, score_dtype, signs):
    # K1's cp.async-fed Hopper variant: ragged q and n, a zero-filled K tail
    # (d % 64 != 0), valid_count mid-bucket, 10% of rows penalised; d=1600
    # with the corpus 4 bytes off 16-byte alignment
    g = torch.Generator(device=dev).manual_seed(d)
    q = _bf16_rows(g, 37, d, dev, signs)
    c = _bf16_rows(g, 5003, d, dev, signs, offset)
    pen = torch.where(torch.rand(5003, device=dev, generator=g) < 0.1,
                      float("-inf"), 0.0)
    assert mips.k1_variant(dev.type, q.dtype, d, (q.data_ptr(), c.data_ptr())) == "cp_async"
    before = (mips.launch_count, mips.wgmma_launch_count, mips.cp_async_launch_count)
    s, bmax = mips.scores_with_bucket_max(q, c, 4037, pen, score_dtype)
    torch.cuda.synchronize()
    assert (mips.launch_count, mips.wgmma_launch_count, mips.cp_async_launch_count) == (
        before[0] + 1, before[1], before[2] + 1)
    s_ref, bmax_ref = mips.scores_with_bucket_max_ref(q, c, 4037, pen, score_dtype)
    if signs and d <= 256:
        # +-1 products sum to integers of magnitude <= 256: exact in f32
        # and in bf16, on both sides
        assert torch.equal(s, s_ref) and torch.equal(bmax, bmax_ref)
        return
    assert torch.equal(torch.isneginf(s), torch.isneginf(s_ref))
    # f32 sums of exact bf16 products in another order; bf16 scores: both
    # sides round the f32 value, one ulp apart at most
    torch.testing.assert_close(bmax, bmax_ref, atol=1e-3, rtol=1e-5)
    rtol = 1e-5 if score_dtype == torch.float32 else 2.0**-7
    torch.testing.assert_close(s.float(), s_ref.float(), atol=1e-3, rtol=rtol)


@pytest.mark.parametrize("q_n,n", [(37, 5003), (300, 4937)])
@pytest.mark.parametrize("d", [202, 250])
def test_cp_async_scores_matmul_matches_plain(dev, q_n, n, d):
    # K6's store-only form on the cp.async-fed kernel: ragged q and n (one
    # or two buckets in the last tile)
    g = torch.Generator(device=dev).manual_seed(q_n + d)
    q = _bf16_rows(g, q_n, d, dev, False)
    c = _bf16_rows(g, n, d, dev, False)
    assert mips.k6_variant(dev.type, q.dtype, d, (q.data_ptr(), c.data_ptr())) == "cp_async"
    before = (mips.scores_matmul_launch_count, mips.scores_matmul_wgmma_launch_count,
              mips.scores_matmul_cp_async_launch_count)
    s = mips.scores_matmul(q, c)
    torch.cuda.synchronize()
    assert (mips.scores_matmul_launch_count, mips.scores_matmul_wgmma_launch_count,
            mips.scores_matmul_cp_async_launch_count) == (before[0] + 1, before[1],
                                                          before[2] + 1)
    # f32 sums of d exact bf16 products (|s| ~ sqrt(d)) in another order
    torch.testing.assert_close(s, mips.scores_matmul_ref(q, c), atol=1e-3, rtol=0)


@pytest.mark.parametrize("score_dtype", [torch.float32, torch.bfloat16])
def test_cp_async_producer_matches_tma_producer(dev, score_dtype):
    # at d=256 both producers can feed the kernel: the same consumers sum
    # the same slots in the same order, so the outputs are bit for bit equal
    from sessionsimilaritysearch_tpu_torch.ops import _build

    lib = _build.load_library()
    g = torch.Generator(device=dev).manual_seed(16)
    q = _bf16_rows(g, 300, 256, dev, False)
    c = _bf16_rows(g, 4937, 256, dev, False)
    pen = torch.where(torch.rand(4937, device=dev, generator=g) < 0.1, float("-inf"), 0.0)
    out = {}
    for name in ("scores_bmax_sm90", "scores_bmax_cp_sm90"):
        s = torch.empty(300, 4937, dtype=score_dtype, device=dev)
        bm = torch.empty(300, 39, device=dev)
        mips._cuda_call(getattr(lib, "sss_" + name), name, dev, q.data_ptr(), c.data_ptr(),
                        pen.data_ptr(), s.data_ptr(), bm.data_ptr(), 300, 4937, 256, 4001,
                        int(score_dtype == torch.bfloat16))
        out[name] = (s, bm)
    torch.cuda.synchronize()
    (s_t, bm_t), (s_c, bm_c) = out.values()
    assert torch.equal(s_t, s_c) and torch.equal(bm_t, bm_c)


def test_cp_async_entry_refuses_rows_it_cannot_take(dev):
    # odd d, or a base 2 bytes off: the C entry refuses and the call raises
    # with the CUDA error code
    from sessionsimilaritysearch_tpu_torch.ops import _build

    lib = _build.load_library()
    q = torch.zeros(8, 38, dtype=torch.bfloat16, device=dev)
    c = torch.zeros(129 * 38, dtype=torch.bfloat16, device=dev)
    s = torch.empty(8, 128, device=dev)
    bm = torch.empty(8, 1, device=dev)
    for d, base in ((37, c.data_ptr()), (38, c.data_ptr() + 2)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            mips._cuda_call(lib.sss_scores_bmax_cp_sm90, "scores_bmax_cp_sm90", dev,
                            q.data_ptr(), base, None, s.data_ptr(), bm.data_ptr(), 8, 128, d,
                            128, 0)


@pytest.mark.parametrize("score_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [5003, 4937])  # the last 128-row tile full or ragged
@pytest.mark.parametrize("d", [36, 200, 1600])  # 36, 200: a zero-filled last K slice
def test_f32_wgmma_kernel_matches_plain(dev, d, n, score_dtype):
    # K1's f32 Hopper variant (the 3xTF32 split): ragged q and n,
    # valid_count mid-bucket, 10% of rows penalised
    g = torch.Generator(device=dev).manual_seed(d + n)
    q = torch.randn(37, d, device=dev, generator=g)
    c = torch.randn(n, d, device=dev, generator=g)
    pen = torch.where(torch.rand(n, device=dev, generator=g) < 0.1, float("-inf"), 0.0)
    assert mips.k1_variant(dev.type, q.dtype, d, (q.data_ptr(), c.data_ptr())) == "wgmma"
    before, before_w = mips.launch_count, mips.wgmma_launch_count
    s, bmax = mips.scores_with_bucket_max(q, c, 4037, pen, score_dtype)
    torch.cuda.synchronize()
    assert (mips.launch_count, mips.wgmma_launch_count) == (before + 1, before_w + 1)
    s_ref, bmax_ref = mips.scores_with_bucket_max_ref(q, c, 4037, pen, score_dtype)
    assert torch.equal(torch.isneginf(s), torch.isneginf(s_ref))
    # f32 sums in another order (|s| ~ sqrt(d)); bf16 scores: both sides
    # round the f32 value, one ulp apart at most
    torch.testing.assert_close(bmax, bmax_ref, atol=1e-3, rtol=1e-5)
    rtol = 1e-5 if score_dtype == torch.float32 else 2.0**-7
    torch.testing.assert_close(s.float(), s_ref.float(), atol=1e-3, rtol=rtol)
    # no penalty and every row valid: the unmasked epilogue
    s, bmax = mips.scores_with_bucket_max(q, c, score_dtype=score_dtype)
    s_ref, bmax_ref = mips.scores_with_bucket_max_ref(q, c, score_dtype=score_dtype)
    torch.testing.assert_close(bmax, bmax_ref, atol=1e-3, rtol=1e-5)
    torch.testing.assert_close(s.float(), s_ref.float(), atol=1e-3, rtol=rtol)


# f32 rows with no 16-byte row stride (d 37, 202), or a corpus 4 bytes off
@pytest.mark.parametrize("d,offset", [(37, 0), (202, 0), (200, 1)])
def test_f32_rows_tma_cannot_take_run_the_tile_loop(dev, d, offset):
    g = torch.Generator(device=dev).manual_seed(d)
    q = torch.randn(37, d, device=dev, generator=g)
    c = torch.randn(5003 * d + offset, device=dev, generator=g)[offset:].view(5003, d)
    assert mips.k1_variant(dev.type, q.dtype, d, (q.data_ptr(), c.data_ptr())) == "tile"
    before = (mips.launch_count, mips.wgmma_launch_count, mips.scores_matmul_launch_count,
              mips.scores_matmul_wgmma_launch_count)
    s, bmax = mips.scores_with_bucket_max(q, c, 4037)
    s6 = mips.scores_matmul(q, c)
    torch.cuda.synchronize()
    assert (mips.launch_count, mips.wgmma_launch_count, mips.scores_matmul_launch_count,
            mips.scores_matmul_wgmma_launch_count) == (before[0] + 1, before[1],
                                                       before[2] + 1, before[3])
    s_ref, bmax_ref = mips.scores_with_bucket_max_ref(q, c, 4037)
    torch.testing.assert_close(bmax, bmax_ref, atol=1e-3, rtol=1e-5)
    torch.testing.assert_close(s, s_ref, atol=1e-3, rtol=1e-5)
    torch.testing.assert_close(s6, mips.scores_matmul_ref(q, c), atol=1e-3, rtol=0)


@pytest.mark.parametrize("unit", [True, False])
def test_f32_wgmma_accuracy_within_twice_sgemm(dev, unit):
    # the accuracy gate at a small size: the split's largest error against
    # the f64 product at most twice cuBLAS SGEMM's (TF32 off) on the same
    # f32 inputs: unit rows at d=1600, standard-normal rows at d=200
    assert not torch.backends.cuda.matmul.allow_tf32
    g = torch.Generator(device=dev).manual_seed(12)
    d = 1600 if unit else 200
    q = torch.randn(256, d, device=dev, generator=g)
    c = torch.randn(16384, d, device=dev, generator=g)
    if unit:
        q, c = (torch.nn.functional.normalize(x) for x in (q, c))
    exact = q.double() @ c.double().T
    before_w = mips.scores_matmul_wgmma_launch_count
    err = (mips.scores_matmul(q, c).double() - exact).abs().max().item()
    assert mips.scores_matmul_wgmma_launch_count == before_w + 1
    s, _ = mips.scores_with_bucket_max(q, c)
    err_k1 = (s.double() - exact).abs().max().item()
    err_sgemm = (torch.matmul(q, c.T).double() - exact).abs().max().item()
    assert max(err, err_k1) <= 2 * err_sgemm, (err, err_k1, err_sgemm)


@pytest.mark.parametrize("q_n,n", [(37, 5003), (300, 4937)])
@pytest.mark.parametrize("d", [36, 200])
def test_f32_wgmma_scores_matmul_matches_plain(dev, q_n, n, d):
    # K6's f32 Hopper variant (store-only epilogue) on ragged q and n
    g = torch.Generator(device=dev).manual_seed(q_n + d)
    q = torch.randn(q_n, d, device=dev, generator=g)
    c = torch.randn(n, d, device=dev, generator=g)
    assert mips.k6_variant(dev.type, q.dtype, d, (q.data_ptr(), c.data_ptr())) == "wgmma"
    b6, w6 = mips.scores_matmul_launch_count, mips.scores_matmul_wgmma_launch_count
    s = mips.scores_matmul(q, c)
    torch.cuda.synchronize()
    assert (mips.scores_matmul_launch_count, mips.scores_matmul_wgmma_launch_count) == (
        b6 + 1, w6 + 1)
    # f32 sums of d products (|s| ~ sqrt(d)) in another order
    torch.testing.assert_close(s, mips.scores_matmul_ref(q, c), atol=1e-3, rtol=1e-5)


def test_kernel_rejects_mismatched_dtypes(dev):
    q = torch.zeros(4, 16, device=dev)
    c = torch.zeros(300, 16, device=dev, dtype=torch.bfloat16)
    before = mips.launch_count
    with pytest.raises(TypeError):
        mips.scores_with_bucket_max(q, c)
    assert mips.launch_count == before


def test_dense_index_search_launches_kernel(dev):
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((3000, 64)).astype(np.float32)
    on_card = DenseIndex(64, 4096, device=dev, chunk_size=1024)
    on_cpu = DenseIndex(64, 4096, device="cpu", chunk_size=1024)
    on_card.add(rows)
    on_cpu.add(rows)
    mask = rng.random(3000) < 0.5
    before, before_w = mips.launch_count, mips.wgmma_launch_count
    D, I = on_card.search(rows[:16], 5, row_mask=mask)
    # one launch per 1024-row chunk, each the f32 Hopper variant (d = 64)
    assert (mips.launch_count, mips.wgmma_launch_count) == (before + 3, before_w + 3)
    Dc, Ic = on_cpu.search(rows[:16], 5, row_mask=mask)
    np.testing.assert_allclose(D, Dc, atol=1e-5, rtol=0)
    assert mask[I].all()


@pytest.mark.parametrize("d", [36, 200, 1600])
def test_l2_index_runs_k1_with_its_penalty(dev, d):
    # metric='l2' through K1's per-row penalty -|c|^2 (and -inf for masked
    # rows): every launch the f32 wgmma variant, and the distances those of
    # the plain version (the CPU index over the same rows) to 1e-5 of
    # |q|^2 + max|c|^2
    rng = np.random.default_rng(d)
    rows = rng.standard_normal((3000, d)).astype(np.float32)
    q = rows[:16] + 0.1 * rng.standard_normal((16, d)).astype(np.float32)
    on_card = DenseIndex(d, 4096, device=dev, metric="l2", chunk_size=1024)
    on_cpu = DenseIndex(d, 4096, device="cpu", metric="l2", chunk_size=1024)
    on_card.add(rows)
    on_cpu.add(rows)
    mask = rng.random(3000) < 0.7
    before, before_w = mips.launch_count, mips.wgmma_launch_count
    D, I = on_card.search(q, 10, row_mask=mask)
    assert (mips.launch_count, mips.wgmma_launch_count) == (before + 3, before_w + 3)
    Dc, Ic = on_cpu.search(q, 10, row_mask=mask)
    scale = float((q**2).sum(1).max() + (rows**2).sum(1).max())
    np.testing.assert_allclose(D, Dc, atol=1e-5 * scale, rtol=0)
    assert mask[I].all() and (np.diff(D, axis=1) >= 0).all()
    exact = ((q[:, None, :].astype(np.float64) - rows[None]) ** 2).sum(-1)
    np.testing.assert_allclose(np.take_along_axis(exact, I, axis=1),
                               np.take_along_axis(exact, Ic, axis=1), atol=1e-5 * scale, rtol=0)


def test_remove_ids_on_card_matches_rebuilt(dev):
    # 'ip' stores the rows as given, so the rebuilt index holds the same
    # bits in the same slots and must return the same top-k, ties included
    rng = np.random.default_rng(3)
    rows = rng.standard_normal((3200, 64)).astype(np.float32)
    idx = DenseIndex(64, 4096, device=dev, metric="ip", chunk_size=1024)
    idx.add(rows[:3000])
    gone = rng.choice(3000, size=500, replace=False)
    stored = idx.reconstruct_batch(np.arange(3000))
    src, dst, new_size = compaction_plan(3000, gone)
    assert idx.remove_ids(gone) == 500 and idx.ntotal == new_size == 2500
    survivors = stored.copy()
    survivors[dst] = survivors[src]
    np.testing.assert_array_equal(idx.reconstruct_batch(np.arange(2500)), survivors[:2500])
    idx.add(rows[3000:])  # into the freed capacity
    fresh = DenseIndex(64, 4096, device=dev, metric="ip", chunk_size=1024)
    fresh.add(np.concatenate([survivors[:2500], rows[3000:]]))
    D, I = idx.search(rows[:32], 10)
    Df, If = fresh.search(rows[:32], 10)
    np.testing.assert_array_equal(I, If)
    np.testing.assert_array_equal(D, Df)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_snapshot_round_trip_on_card(dev, dtype, tmp_path):
    rng = np.random.default_rng(4)
    rows = rng.standard_normal((3000, 64)).astype(np.float32)
    idx = DenseIndex(64, 4096, device=dev, dtype=dtype, chunk_size=1024)
    idx.add(rows)
    idx.remove_ids([0, 5, 2999])
    idx.save(str(tmp_path / "snap"))
    back = DenseIndex.load(str(tmp_path / "snap"), device=dev)
    on_cpu = DenseIndex.load(str(tmp_path / "snap"), device="cpu")
    assert back.dtype == on_cpu.dtype == dtype and back.ntotal == 2997
    stored = idx.reconstruct_batch(np.arange(2997))
    np.testing.assert_array_equal(back.reconstruct_batch(np.arange(2997)), stored)
    np.testing.assert_array_equal(on_cpu.reconstruct_batch(np.arange(2997)), stored)
    for a, b in zip(back.search(rows[:16], 10), idx.search(rows[:16], 10)):
        np.testing.assert_array_equal(a, b)


def test_engine_on_card_matches_cpu(dev):
    cfg = port.tiny_test_config()
    tok = port.get_tokenizer(cfg.vocab_size)
    data = port.SyntheticSessionGenerator(asin_num=cfg.asin_num, seed=0).dataset(60)
    enc_cpu = port.build_graph_encoder(cfg, "cpu")
    enc_card = port.build_graph_encoder(cfg, dev)
    enc_card.load_state_dict(enc_cpu.state_dict())  # the same weights
    kw = dict(dim=cfg.session_emb_dim, capacity=128, batch_size=16)
    cpu = port.SessionSearchEngine(cfg, tok, enc_cpu, device="cpu", **kw)
    card = port.SessionSearchEngine(cfg, tok, enc_card, device=dev, **kw)
    cpu.add_sessions(data)
    card.add_sessions(data)
    before = mips.launch_count
    Dg, Ig = card.search(data[:10], k=5)
    assert mips.launch_count > before
    Dc, Ic = cpu.search(data[:10], k=5)
    np.testing.assert_allclose(Dg, Dc, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(Ig[:, 0], np.arange(10))


def _signs(g, rows, bits, dev):
    return torch.where(torch.rand(rows, bits, generator=g, device=dev) < 0.5, 1.0, -1.0)


@pytest.mark.parametrize("n_bits", [250, 384])
def test_packed_kernel_matches_plain(dev, n_bits):
    # q=37 (ragged tile), three pack blocks, valid_count mid-block, 10% masked
    g = torch.Generator(device=dev).manual_seed(0)
    bits_pad = -(-n_bits // 128) * 128
    words = hamming.pack_bits_t(torch.nn.functional.pad(
        _signs(g, 6144, n_bits, dev), (0, bits_pad - n_bits), value=-1.0))
    q = torch.nn.functional.pad(_signs(g, 37, n_bits, dev),
                                (0, bits_pad - n_bits)).bfloat16()
    pen = torch.where(torch.rand(6144, generator=g, device=dev) < 0.1,
                      float("-inf"), 0.0)
    sd = torch.bfloat16 if n_bits <= 256 else torch.float32
    before = packed.launch_count
    s, bmax = packed.packed_scores_with_bucket_max(q, words, 5003, pen, sd)
    torch.cuda.synchronize()
    assert packed.launch_count == before + 1
    s_ref, bmax_ref = packed.packed_scores_with_bucket_max_ref(q, words, 5003, pen, sd)
    # +-1 products are small integers: exact on both sides
    assert torch.equal(s, s_ref)
    assert torch.equal(bmax, bmax_ref)
    d, i = packed.packed_topk(q, words, 10, n_bits, 5003, pen)
    assert packed.launch_count == before + 2
    d_ref, _ = hamming.oracle_hamming_np(
        q.float().cpu().numpy()[:, :n_bits],
        hamming.unpack_bits_t(words).float().cpu().numpy()[:5003][
            (pen[:5003] == 0).cpu().numpy(), :n_bits], 10)
    np.testing.assert_array_equal(d.cpu().numpy(), d_ref)


@pytest.mark.parametrize("score_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_n", [37, 300])
@pytest.mark.parametrize("bits", [128, 256, 384, 1536, 1664, 2048, 4096])
def test_packed_kernel_bit_equal_across_widths(dev, bits, q_n, score_dtype):
    # every K-slice count; the resident layout (128 bits, 256 with bf16
    # scores: the pack block's words staged) and the streamed one (the
    # corpus row-major, the query slices through the ring) at every other
    # width, past the 1,536 bits the kernel once refused; +-1 products are
    # exact on both sides
    g = torch.Generator(device=dev).manual_seed(bits + q_n)
    words = hamming.pack_bits_t(_signs(g, 6144, bits, dev))
    q = _signs(g, q_n, bits, dev).bfloat16()
    pen = torch.where(torch.rand(6144, generator=g, device=dev) < 0.1,
                      float("-inf"), 0.0)
    before = packed.launch_count
    s, bmax = packed.packed_scores_with_bucket_max(q, words, 5003, pen, score_dtype)
    torch.cuda.synchronize()
    assert packed.launch_count == before + 1
    s_ref, bmax_ref = packed.packed_scores_with_bucket_max_ref(q, words, 5003, pen,
                                                               score_dtype)
    assert torch.equal(s, s_ref)
    assert torch.equal(bmax, bmax_ref)


def test_hamming_kernel_matches_plain(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    c = hamming.pack_bits(_signs(g, 6144, 250, dev))
    q = hamming.pack_bits(_signs(g, 37, 250, dev))
    live = torch.rand(6144, generator=g, device=dev) < 0.9
    live[5003:] = False
    pen = torch.where(live, 0, popcount.PENALTY).to(torch.int32)
    before = popcount.launch_count
    bmin = popcount.hamming_bucket_min(q, c, pen)
    torch.cuda.synchronize()
    assert popcount.launch_count == before + 1
    assert torch.equal(bmin, popcount.hamming_bucket_min_ref(q, c, pen))
    # a ragged corpus (a partial last bucket and block), no penalty
    assert torch.equal(popcount.hamming_bucket_min(q, c[:5003]),
                       popcount.hamming_bucket_min_ref(q, c[:5003]))
    d, i = hamming.hamming_topk(q, c, 10, valid_count=5003, row_mask=live)
    d_ref, i_ref = hamming.hamming_topk(q.cpu(), c.cpu(), 10, valid_count=5003,
                                        row_mask=live.cpu())
    np.testing.assert_array_equal(d.cpu().numpy(), d_ref.numpy())
    assert live[i].all()


@pytest.mark.parametrize("with_penalty", [False, True])
@pytest.mark.parametrize("n", [1, 127, 5003, 6144])
@pytest.mark.parametrize("words", [1, 3, 8, 13, 53, 54, 64, 128])
def test_hamming_wgmma_kernel_matches_plain(dev, words, n, with_penalty):
    # up to 32 words a resident query tile of 256 or 128 queries; from 33
    # (53 and wider here) the query slices streamed, at 54, 64 and 128 words
    # past the width the kernel once refused
    g = torch.Generator(device=dev).manual_seed(words * 7 + n)
    c = torch.randint(-2**31, 2**31 - 1, (n, words), generator=g, device=dev,
                      dtype=torch.int32)
    q = torch.randint(-2**31, 2**31 - 1, (200, words), generator=g, device=dev,
                      dtype=torch.int32)
    pen = None
    if with_penalty:
        live = torch.rand(n, generator=g, device=dev) >= 0.1
        live[int(0.9 * n) + 1:] = False
        live[128:256] = False  # one bucket wholly dead
        pen = torch.where(live, 0, popcount.PENALTY).to(torch.int32)
    before = (popcount.launch_count, popcount.wgmma_launch_count)
    for q_n in (1, 37, 200):
        bmin = popcount.hamming_bucket_min(q[:q_n], c, pen)
        torch.cuda.synchronize()
        assert torch.equal(bmin, popcount.hamming_bucket_min_ref(q[:q_n], c, pen))
    assert (popcount.launch_count, popcount.wgmma_launch_count) == (before[0] + 3,
                                                                    before[1] + 3)


def test_hamming_wgmma_kernel_wraps_the_penalty_add(dev):
    g = torch.Generator(device=dev).manual_seed(2)
    c = torch.randint(-2**31, 2**31 - 1, (5003, 8), generator=g, device=dev, dtype=torch.int32)
    q = torch.randint(-2**31, 2**31 - 1, (37, 8), generator=g, device=dev, dtype=torch.int32)
    pen = torch.randint(-2**31, 2**31 - 1, (5003,), generator=g, device=dev, dtype=torch.int32)
    assert torch.equal(popcount.hamming_bucket_min(q, c, pen),
                       popcount.hamming_bucket_min_ref(q, c, pen))


@pytest.mark.parametrize("view", ["corpus", "penalty"])
def test_hamming_misaligned_view_runs_popc(dev, view):
    g = torch.Generator(device=dev).manual_seed(3)
    c = torch.randint(-2**31, 2**31 - 1, (5008, 3), generator=g, device=dev, dtype=torch.int32)
    q = torch.randint(-2**31, 2**31 - 1, (37, 3), generator=g, device=dev, dtype=torch.int32)
    pen = torch.zeros(5008, dtype=torch.int32, device=dev)
    args = (q, c[5:], None) if view == "corpus" else (q, c[4:], pen[1:5005])
    before = (popcount.launch_count, popcount.wgmma_launch_count)
    bmin = popcount.hamming_bucket_min(*args)
    assert (popcount.launch_count, popcount.wgmma_launch_count) == (before[0] + 1, before[1])
    assert torch.equal(bmin, popcount.hamming_bucket_min_ref(*args))


@pytest.mark.parametrize("with_penalty", [False, True])
@pytest.mark.parametrize("n", [127, 5003, 6144])
@pytest.mark.parametrize("words", [54, 64, 128])
def test_hamming_popc_wide_codes_match_plain(dev, words, n, with_penalty):
    # codes wider than the popc kernel's one staging (53 words) walk their
    # words in chunks; a corpus 4 bytes off a 16-byte boundary is the popc
    # variant's input at every width
    g = torch.Generator(device=dev).manual_seed(words * 11 + n)
    flat = torch.randint(-2**31, 2**31 - 1, (n * words + 1,), generator=g, device=dev,
                         dtype=torch.int32)
    c = flat[1:].view(n, words)
    q = torch.randint(-2**31, 2**31 - 1, (200, words), generator=g, device=dev,
                      dtype=torch.int32)
    pen = None
    if with_penalty:
        live = torch.rand(n, generator=g, device=dev) >= 0.1
        live[int(0.9 * n) + 1:] = False
        pen = torch.where(live, 0, popcount.PENALTY).to(torch.int32)
    before = (popcount.launch_count, popcount.wgmma_launch_count)
    for q_n in (1, 37, 200):
        bmin = popcount.hamming_bucket_min(q[:q_n], c, pen)
        torch.cuda.synchronize()
        assert torch.equal(bmin, popcount.hamming_bucket_min_ref(q[:q_n], c, pen))
    assert (popcount.launch_count, popcount.wgmma_launch_count) == (before[0] + 3, before[1])


@pytest.mark.parametrize("mode", ["packed", "sign"])
def test_binary_index_launches_kernel(dev, mode):
    rng = np.random.default_rng(0)
    c = np.where(rng.random((5003, 250)) < 0.5, 1.0, -1.0).astype(np.float32)
    on_card = BinaryIndex(250, 6000, mode, device=dev)
    on_cpu = BinaryIndex(250, 6000, mode, device="cpu")
    for lo, hi in ((0, 1000), (1000, 5003)):
        on_card.add(c[lo:hi])
        on_cpu.add(c[lo:hi])
    assert torch.equal(on_card._buf.cpu(), on_cpu._buf)
    mask = rng.random(5003) < 0.5
    counter = packed if mode == "packed" else mips
    before = counter.launch_count
    D, I = on_card.search(c[:16], 10, row_mask=mask)
    assert counter.launch_count == before + 1
    Dc, _ = on_cpu.search(c[:16], 10, row_mask=mask)
    np.testing.assert_array_equal(D, Dc)
    assert mask[I].all()


def test_twostage_index_launches_kernel(dev):
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((3000, 64)).astype(np.float32)
    proj = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32))
    kw = dict(prefilter="binary", n_bits=128, stage1="packed", projection=proj)
    on_card = TwoStageIndex(64, 4096, device=dev, **kw)
    on_cpu = TwoStageIndex(64, 4096, device="cpu", **kw)
    on_card.add(rows)
    on_cpu.add(rows)
    before = packed.launch_count
    # the pool holds every row: the codes of a near-zero projection may
    # differ between the card's and the CPU's f32 sums, the result may not
    D, I = on_card.search(rows[:16], 5, pool=4096)
    assert packed.launch_count == before + 1
    Dc, _ = on_cpu.search(rows[:16], 5, pool=4096)
    np.testing.assert_allclose(D, Dc, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(I[:, 0], np.arange(16))


def _int8_case(g, q, n, d, dev):
    qc = torch.randint(-127, 128, (q, d), generator=g, device=dev).to(torch.int8)
    cc = torch.randint(-127, 128, (n, d), generator=g, device=dev).to(torch.int8)
    return qc, cc, torch.rand(n, generator=g, device=dev) * 0.01


@pytest.mark.parametrize("score_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [200, 37])  # 37: no 16-byte rows, byte loads
def test_int8_kernel_matches_plain(dev, d, score_dtype):
    # K2's tile variant: rows that are no TMA stride (d % 16 != 0)
    g = torch.Generator(device=dev).manual_seed(2)
    qc, cc, sc = _int8_case(g, 37, 5003, d, dev)
    pen = torch.where(torch.rand(5003, device=dev, generator=g) < 0.1,
                      float("-inf"), 0.0)
    assert mips_int8.k2_variant(dev.type, d, (qc.data_ptr(), cc.data_ptr(),
                                              sc.data_ptr())) == "tile"
    before, before_w = mips_int8.launch_count, mips_int8.wgmma_launch_count
    s, bmax = mips_int8.scores_with_bucket_max_int8(qc, cc, sc, 4037, pen, score_dtype)
    torch.cuda.synchronize()
    assert (mips_int8.launch_count, mips_int8.wgmma_launch_count) == (before + 1, before_w)
    s_ref, bmax_ref = mips_int8.scores_with_bucket_max_int8_ref(
        qc, cc, sc, 4037, pen, score_dtype)
    # exact int32 dots on both sides, then the same two f32 roundings
    assert torch.equal(s, s_ref) and torch.equal(bmax, bmax_ref)


@pytest.mark.parametrize("score_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [5003, 4937])  # the last 256-row tile: two buckets, one
@pytest.mark.parametrize("d", [144, 208, 1600])  # 144, 208: a zero-filled last K slice
def test_wgmma_int8_kernel_matches_plain(dev, d, n, score_dtype):
    # K2's Hopper variant: ragged q and n, valid_count mid-bucket, 10% of
    # rows penalised; exact int32 dots, so equal, not close
    g = torch.Generator(device=dev).manual_seed(d + n)
    qc, cc, sc = _int8_case(g, 37, n, d, dev)
    pen = torch.where(torch.rand(n, device=dev, generator=g) < 0.1, float("-inf"), 0.0)
    assert mips_int8.k2_variant(dev.type, d, (qc.data_ptr(), cc.data_ptr(),
                                              sc.data_ptr())) == "wgmma"
    before, before_w = mips_int8.launch_count, mips_int8.wgmma_launch_count
    s, bmax = mips_int8.scores_with_bucket_max_int8(qc, cc, sc, 4037, pen, score_dtype)
    torch.cuda.synchronize()
    assert (mips_int8.launch_count, mips_int8.wgmma_launch_count) == (before + 1,
                                                                      before_w + 1)
    s_ref, bmax_ref = mips_int8.scores_with_bucket_max_int8_ref(
        qc, cc, sc, 4037, pen, score_dtype)
    assert torch.equal(s, s_ref) and torch.equal(bmax, bmax_ref)
    # no penalty and every row valid: the unmasked epilogue
    s, bmax = mips_int8.scores_with_bucket_max_int8(qc, cc, sc, score_dtype=score_dtype)
    s_ref, bmax_ref = mips_int8.scores_with_bucket_max_int8_ref(qc, cc, sc,
                                                                score_dtype=score_dtype)
    assert torch.equal(s, s_ref) and torch.equal(bmax, bmax_ref)


def test_int8_unaligned_scales_run_the_tile_variant(dev):
    g = torch.Generator(device=dev).manual_seed(8)
    qc, cc, sc = _int8_case(g, 37, 5004, 208, dev)
    cc, sc = cc[1:], sc[1:]  # codes 208 bytes on (16-byte aligned), scales 4 bytes on
    assert mips_int8.k2_variant(dev.type, 208, (qc.data_ptr(), cc.data_ptr(),
                                                sc.data_ptr())) == "tile"
    before_w = mips_int8.wgmma_launch_count
    s, bmax = mips_int8.scores_with_bucket_max_int8(qc, cc, sc, 4037)
    torch.cuda.synchronize()
    assert mips_int8.wgmma_launch_count == before_w
    s_ref, bmax_ref = mips_int8.scores_with_bucket_max_int8_ref(qc, cc, sc, 4037)
    assert torch.equal(s, s_ref) and torch.equal(bmax, bmax_ref)


@pytest.mark.parametrize("bad", ["scales_len", "scales_dtype", "float_codes",
                                 "not_contiguous", "penalty_len"])
def test_int8_kernel_rejects_what_it_does_not_take(dev, bad):
    g = torch.Generator(device=dev).manual_seed(3)
    qc, cc, sc = _int8_case(g, 4, 300, 64, dev)
    kw = {}
    if bad == "scales_len":
        sc = sc[:299]
    elif bad == "scales_dtype":
        sc = sc.double()
    elif bad == "float_codes":
        qc = qc.float()
    elif bad == "not_contiguous":
        cc = torch.randint(-127, 128, (64, 300), generator=g, device=dev).to(torch.int8).T
    else:
        kw["penalty"] = torch.zeros(299, device=dev)
    before = mips_int8.launch_count
    with pytest.raises((TypeError, ValueError)):
        mips_int8.scores_with_bucket_max_int8(qc, cc, sc, **kw)
    assert mips_int8.launch_count == before


def test_int8x8_index_launches_kernel_per_chunk(dev):
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((3000, 64)).astype(np.float32)
    on_card = DenseIndex(64, 4096, device=dev, chunk_size=1024, quantize="int8x8")
    on_cpu = DenseIndex(64, 4096, device="cpu", chunk_size=1024, quantize="int8x8")
    on_card.add(rows)
    on_cpu.add(rows)
    assert torch.equal(on_card._buf.cpu(), on_cpu._buf)
    mask = rng.random(3000) < 0.5
    before, before_w = mips_int8.launch_count, mips_int8.wgmma_launch_count
    D, I = on_card.search(rows[:16], 5, row_mask=mask)
    # one launch per 1024-row chunk, each the Hopper variant (d = 64)
    assert (mips_int8.launch_count, mips_int8.wgmma_launch_count) == (before + 3,
                                                                      before_w + 3)
    Dc, _ = on_cpu.search(rows[:16], 5, row_mask=mask)
    np.testing.assert_allclose(D, Dc, rtol=1e-6, atol=0)
    assert mask[I].all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bucket_max_and_matmul_kernels_match_plain(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(4)
    q = torch.randn(37, 200, device=dev, generator=g).to(dtype)
    c = torch.randn(5003, 200, device=dev, generator=g).to(dtype)
    b3, b6 = mips.bucket_max_launch_count, mips.scores_matmul_launch_count
    w6 = mips.scores_matmul_wgmma_launch_count
    bmax = mips.scores_bucket_max(q, c, 4037)
    s = mips.scores_matmul(q, c)
    torch.cuda.synchronize()
    assert mips.bucket_max_launch_count == b3 + 1
    assert mips.scores_matmul_launch_count == b6 + 1
    # K1's Hopper kernels with the store-only epilogue (d = 200: a TMA stride
    # for both dtypes)
    assert mips.scores_matmul_wgmma_launch_count == w6 + 1
    # f32 sums of 200 terms (|s| ~ 15) in another order
    torch.testing.assert_close(bmax, mips.scores_bucket_max_ref(q, c, 4037),
                               atol=1e-3, rtol=0)
    torch.testing.assert_close(s, mips.scores_matmul_ref(q, c), atol=1e-3, rtol=0)


@pytest.mark.parametrize("q_n,n", [(37, 5003), (300, 4937)])
def test_wgmma_scores_matmul_matches_plain(dev, q_n, n):
    # K6's Hopper variant on ragged q and n (one or two buckets in the last
    # tile), and K6's tile loop on rows TMA cannot take (d = 37)
    g = torch.Generator(device=dev).manual_seed(q_n)
    for d, variant in ((200, "wgmma"), (37, "tile")):
        q = torch.randn(q_n, d, device=dev, generator=g).bfloat16()
        c = torch.randn(n, d, device=dev, generator=g).bfloat16()
        assert mips.k6_variant(dev.type, q.dtype, d, (q.data_ptr(), c.data_ptr())) == variant
        b6, w6 = mips.scores_matmul_launch_count, mips.scores_matmul_wgmma_launch_count
        s = mips.scores_matmul(q, c)
        torch.cuda.synchronize()
        assert (mips.scores_matmul_launch_count, mips.scores_matmul_wgmma_launch_count) == (
            b6 + 1, w6 + (variant == "wgmma"))
        # f32 sums of d exact bf16 products (|s| ~ sqrt(d)) in another order
        torch.testing.assert_close(s, mips.scores_matmul_ref(q, c), atol=1e-3, rtol=0)


def test_bucketed_topk_matches_exact_topk(dev):
    g = torch.Generator(device=dev).manual_seed(5)
    c = torch.nn.functional.normalize(torch.randn(20000, 128, device=dev, generator=g))
    q = c[:8].bfloat16()
    before = mips.bucket_max_launch_count
    v, i = mips.bucketed_topk(q, c.bfloat16(), 20, valid_count=19000)
    assert mips.bucket_max_launch_count == before + 1
    v_ex, _ = mips.exact_topk(q, c.bfloat16(), 20, valid_count=19000)
    # the two differ only in the order of f32 sums over unit rows
    torch.testing.assert_close(v, v_ex, atol=1e-5, rtol=1e-5)
    assert (i < 19000).all() and torch.equal(i[:, 0], torch.arange(8, device=dev))


@pytest.mark.parametrize("pooling", ["srgnn", "recency"])
def test_flagship_serving_on_the_card_matches_the_cpu(dev, pooling):
    # bf16 serving parameters, catalog tables and the cached forward in a
    # default engine on the card; the same weights on the CPU
    from sessionsimilaritysearch_tpu_torch.evalharness import harness as H
    from sessionsimilaritysearch_tpu_torch.utils.precision import serving_params

    cfg = port.tiny_test_config().replace(product_pooling=pooling)
    tok = port.get_tokenizer(cfg.vocab_size)
    gen = port.SyntheticSessionGenerator(asin_num=cfg.asin_num, seed=0)
    data = [d for d in gen.dataset(120) if any(a[1] != "s" for a in d[0])]
    kws = [a[2] or "" for s, _ in data for a in s if a[1] == "s"]
    enc = port.build_graph_encoder(cfg, "cpu", torch.Generator().manual_seed(0))
    out, fns = {}, []
    for where in (torch.device("cpu"), dev):
        served = serving_params(enc).to(where)
        fn = H.make_cached_encode_fn(served, H.build_title_table(cfg, tok, gen.titles, served),
                                     *H.build_keyword_table(cfg, tok, kws, served))
        eng = port.SessionSearchEngine(cfg, tok, fn, dim=cfg.session_emb_dim, capacity=256,
                                       batch_size=32, device=where)
        before = mips.launch_count
        eng.add_sessions(data)
        D, I = eng.search(data[:16], k=5)
        if where.type == "cuda":
            assert mips.launch_count > before
        assert (I[:, 0] == np.arange(16)).all() and np.abs(D[:, 0] - 1.0).max() <= 1e-3
        out[where.type] = eng.reconstruct(range(len(data)))
        fns.append(fn)
    assert all(f.oov_batches == 0 for f in fns)
    got, want = out["cuda"].astype(np.float64), out["cpu"].astype(np.float64)
    cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1))
    assert cos.min() >= 0.999 and np.abs(got - want).max() <= 2.0**-6 * np.abs(want).max()


@pytest.mark.parametrize("mode", ["exact", "approx", "sort"])
@pytest.mark.parametrize("kind", ["bf16", "f32_l2", "int8x8"])
def test_chunked_topk_on_card_matches_cpu(dev, mode, kind):
    # the selection layer: K1 (bf16, f32 with l2's penalty) or K2 per chunk,
    # ragged chunks, valid_count and a row mask, against the CPU's plain run
    from sessionsimilaritysearch_tpu_torch.ops import topk

    g = torch.Generator().manual_seed(12)
    q = torch.randn(37, 208, generator=g)
    c = torch.randn(5003, 208, generator=g)
    mask = torch.rand(5003, generator=g) < 0.8
    kw = dict(chunk_size=2048, mode=mode, valid_count=4500, row_mask=mask)
    if kind == "bf16":
        args, kw["score_dtype"] = (q.bfloat16(), c.bfloat16()), torch.bfloat16
    elif kind == "f32_l2":
        args, kw["metric"] = (q, c), "l2"
    else:
        q8, qs = mips_int8.quantize_rows_int8(q)
        c8, cs = mips_int8.quantize_rows_int8(c)
        args = (q8, c8)
        kw.update(corpus_scales=cs, query_scales=qs)
    before = (mips.launch_count, mips_int8.launch_count)
    on_card = {k: v.to(dev) if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
    v, i = topk.chunked_topk(*(a.to(dev) for a in args), 10, **on_card)
    v_ref, i_ref = topk.chunked_topk(*args, 10, **kw)
    launched = (mips.launch_count - before[0], mips_int8.launch_count - before[1])
    assert launched == ((0, 3) if kind == "int8x8" else (3, 0))
    scale = v_ref.abs().amax(dim=1, keepdim=True)
    tol = 2 * 2.0**-8 if kind == "bf16" else 1e-5
    assert ((v.cpu() - v_ref).abs() <= tol * scale).all()
    assert mask[i.cpu()].all() and (i.cpu() < 4500).all()


@pytest.mark.parametrize("mode", ["packed", "sign"])
def test_binary_verbs_on_card_match_cpu(dev, mode, tmp_path):
    # remove_ids (packed: the bit moves), refill, merge and a snapshot on the
    # card leave the same buffer as on the CPU, word for word
    g = torch.Generator().manual_seed(13)
    codes = torch.where(torch.rand(6000, 256, generator=g) < 0.5, 1.0, -1.0)
    ids = torch.randperm(5000, generator=g)[:400].numpy()
    pair = [BinaryIndex(256, 8192, mode, device=d) for d in (dev, "cpu")]
    for idx in pair:
        idx.add(codes[:5000])
        idx.remove_ids(ids)
        idx.add(codes[5000:])
    assert torch.equal(pair[0]._buf.cpu(), pair[1]._buf)
    (d, _), (d_ref, _) = pair[0].search(codes[:16], 20), pair[1].search(codes[:16], 20)
    np.testing.assert_array_equal(np.sort(d, 1), np.sort(d_ref, 1))
    pair[0].save(str(tmp_path / "b"))
    back = BinaryIndex.load(str(tmp_path / "b"), device=dev)
    assert torch.equal(back._buf[: pair[0]._buf.shape[0]], pair[0]._buf)
    merged = BinaryIndex(256, 16384, "sign" if mode == "packed" else "packed", device=dev)
    merged.merge_from(pair[0])
    np.testing.assert_array_equal(merged.reconstruct_batch(np.arange(5600)),
                                  pair[1].reconstruct_batch(np.arange(5600)))


@pytest.mark.parametrize("prefilter,stage1,n_bits", [
    ("binary", "matmul", 256), ("itq", "matmul", 250), ("int8x8", "matmul", 0),
    ("pca", "matmul", 64), ("itq", "packed", 250)])
def test_twostage_tiers_on_card_match_cpu(dev, prefilter, stage1, n_bits, tmp_path):
    # every stage 1 on the card (K1 wgmma at 256 bits and pca 64, K1
    # cp_async at 250, K2, K4) after a removal, against the CPU's plain run of the same
    # index with a pool of every row (f32 products in another order may
    # flip a near-zero code bit, so a partial pool may differ at its edge),
    # and a snapshot round trip on the card with a pool of 64
    from sessionsimilaritysearch_tpu_torch.ops.projection import fit_itq, fit_pca

    g = torch.Generator().manual_seed(14)
    rows = torch.nn.functional.normalize(torch.randn(4096, 320, generator=g), dim=1)
    proj = (fit_itq(rows[:2048], n_bits) if prefilter == "itq"
            else fit_pca(rows[:2048], n_bits) if prefilter == "pca" else None)
    kw = dict(prefilter=prefilter, stage1=stage1, projector=proj, n_bits=n_bits or 256,
              pool=64)
    pair = [TwoStageIndex(320, 4096, device=d, **kw) for d in (dev, "cpu")]
    for idx in pair:
        idx.add(rows)
        idx.remove_ids(np.arange(0, 4096, 5))
    counts = (mips.launch_count, mips_int8.launch_count, packed.launch_count)
    q = rows[1:33] + 0.1 * torch.randn(32, 320, generator=g)
    D, I = pair[0].search(q, 10, pool=4096)
    D_ref, _ = pair[1].search(q, 10, pool=4096)
    launched = [a - b for a, b in zip((mips.launch_count, mips_int8.launch_count,
                                       packed.launch_count), counts)]
    want = {"int8x8": [0, 1, 0], "packed": [0, 0, 1]}.get(
        prefilter if prefilter == "int8x8" else stage1, [1, 0, 0])
    assert launched == want
    np.testing.assert_allclose(D, D_ref, atol=1e-5, rtol=0)
    pool64 = pair[0].search(q, 10)
    pair[0].save(str(tmp_path / "s"))
    back = TwoStageIndex.load(str(tmp_path / "s"), device=dev)
    for a, b in zip(back.search(q, 10), pool64):
        np.testing.assert_array_equal(a, b)
