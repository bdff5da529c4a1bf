#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``sessionsimilaritysearch_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``csrc/`` (nvcc, first use), then:

1. device   -- a CUDA device must be visible; otherwise exit 1, no result;
2. kernel   -- the fused score + bucket-max kernel against its plain PyTorch
               version: a ragged case (q=37, n=5003, d=200; f32 and bf16;
               valid_count mid-bucket; 10% of rows masked by the penalty)
               and the bench point (q=1024, n=2^20, d=1600, bf16, k=100),
               both timed with CUDA events;
3. index    -- DenseIndex(1600, 2^20, bf16 storage and scores) filled with
               2^20 seeded unit rows, searched with 1024 queries at k=100;
               value-recall@10 >= 0.999 against the f64 numpy oracle on a
               65,536-row subcorpus at two bf16 ulps; the kernel against its
               plain version on one 65,536-row chunk as search() passes it;
4. engine   -- the flagship GraphLevelEncoder at Config() width with seeded
               random weights inside SessionSearchEngine: ingest 8,192
               synthetic sessions, search 256 of them at k=100 (every top-1
               score within 1e-3 of 1.0); the kernel against its plain
               version on the engine's own f32 queries and corpus (d=1600),
               and search()'s scores against the plain top-100; 8 sessions
               encoded on the card and on the CPU with the same weights
               must agree.

5. packed kernel -- K4 (csrc/packed_scores_bmax.cu) against its plain
               version: a ragged case (q=37, three 2048-row pack blocks,
               250 and 384 bits, valid_count 5003, 10% masked) and the bench
               point (q=1024, n=2^20, 256 bits, bf16 scores); scores and
               bucket maxes equal, top-k distances equal; CUDA-event times;
6. hamming kernel -- K5 (csrc/hamming_bucket_min.cu) against its plain
               version on the same codes packed row-major, its time beside
               K4's at the same shape, and ops.hamming.hamming_topk (K5's
               path) giving the same top-100 distances as K4;
7. binary index -- BinaryIndex(250 bits, 2^20 rows), packed (K4) and sign
               (K1) modes, 1024 queries at k=100: sorted distances equal a
               plain f32 product over the same codes;
8. two-stage index -- TwoStageIndex(1600-d, 2^20 rows, 'itq' 250-bit codes
               fitted on a 32,768-row sample, packed stage 1, pool 128, bf16
               rows), 1024 queries planted at cosine ~0.9 to stored rows:
               stage-1 distances equal the plain version's, the top-100
               equals the exact re-rank of the pool within 1e-5, every
               planted row is the top-1; stage-1, re-rank and total times;
9. two-stage engine -- SessionSearchEngine at Config() width with
               prefilter='itq', stage1='packed', pool=512 (projector fitted
               on phase 4's 8,192 embeddings): ingest, search 256 sessions,
               top-1 within two bf16 ulps of 1.0, K4 launched, K4 against its
               plain version on the engine's own codes.

Before phase 4 the shared native graph builder must load (built without
OpenMP where the compiler has no OpenMP runtime; the build used is printed).
The second-to-last line is a JSON object describing each kernel, with the
launches counted on its path (K1: phase 4's engine; K4: phase 9's engine;
K5: phase 6's hamming_topk); the last line is
``{"ok": true, "device": {...}}``. Any failed check exits non-zero.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BF16_TOL = 2 * 2.0**-8  # two bf16 ulps, relative to the per-query scale


def check(cond: bool, what: str) -> None:
    if not cond:
        print(f"FAIL: {what}", file=sys.stderr)
        sys.exit(1)


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream, after one
    warm-up call, from CUDA events around ``iters`` back-to-back calls."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def run_phase(torch, name, fn, *args):
    """Run one phase and print its time from CUDA events around it."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*args)
    end.record()
    torch.cuda.synchronize()
    print(f"phase {name}: {start.elapsed_time(end) / 1e3:.2f} s (CUDA events)")
    return out


def value_recall(torch, topk_mod, exact, ids, k, rel_tol):
    """Value-recall of ``ids`` [q, k] against the exact scores [q, n]
    (f64 or f32 on the device; -inf where a row may not rank)."""
    oracle = torch.topk(exact, k, dim=1).values
    got = torch.gather(exact, 1, ids.clamp(min=0))
    got = torch.where(ids >= 0, got, float("-inf"))
    scale = torch.where(torch.isfinite(exact), exact.abs(), 0.0).amax(dim=1)
    return topk_mod.value_recall_from_scores(
        got.cpu().numpy(), oracle.cpu().numpy(), rel_tol * scale.cpu().numpy()
    )


def phase_kernel_ragged(torch, mips, topk_mod, dev):
    errs = []
    for dt in (torch.float32, torch.bfloat16):
        g = torch.Generator(device=dev).manual_seed(0)
        q = torch.randn(37, 200, generator=g, device=dev).to(dt)
        c = torch.randn(5003, 200, generator=g, device=dev).to(dt)
        pen = torch.where(torch.rand(5003, generator=g, device=dev) < 0.1,
                          float("-inf"), 0.0)
        vc = 4037  # mid-bucket: 4037 = 31 * 128 + 69
        ms = cuda_ms(torch, lambda: mips.scores_with_bucket_max(q, c, vc, pen, dt), 20)
        plain_ms = cuda_ms(torch, lambda: mips.scores_with_bucket_max_ref(
            q, c, vc, pen, dt), 20)
        s, bm = mips.scores_with_bucket_max(q, c, vc, pen, dt)
        s_ref, bm_ref = mips.scores_with_bucket_max_ref(q, c, vc, pen, dt)
        torch.cuda.synchronize()
        check(torch.equal(torch.isneginf(s), torch.isneginf(s_ref)),
              f"ragged {dt}: -inf pattern of the scores differs")
        check(torch.equal(torch.isneginf(bm), torch.isneginf(bm_ref)),
              f"ragged {dt}: -inf pattern of bmax differs")
        fin = torch.isfinite(bm_ref)
        bm_err = (bm[fin] - bm_ref[fin]).abs().max().item()
        fin_s = torch.isfinite(s_ref)
        s_err = (s.float()[fin_s] - s_ref.float()[fin_s]).abs()
        s_rel = (s_err / s_ref.float()[fin_s].abs().clamp(min=1.0)).max().item()
        # f32: another summation order (|s| ~ 15); bf16: both sides round
        # the f32 value to nearest even, one ulp apart at most
        check(bm_err <= 1e-3, f"ragged {dt}: bmax max_abs_err {bm_err}")
        check(s_rel <= (1e-5 if dt == torch.float32 else 2.0**-7),
              f"ragged {dt}: scores max rel err {s_rel}")
        v, i = mips.select_topk(s, bm, 10)
        v_ref, _ = mips.select_topk(s_ref, bm_ref, 10)
        v_err = (v - v_ref).abs().max().item()
        v_tol = 1e-3 if dt == torch.float32 else 2.0**-7 * v_ref.abs().max().item()
        check(v_err <= v_tol, f"ragged {dt}: top-10 values max_abs_err {v_err}")
        exact = q.double() @ c.double().T
        exact[:, vc:] = float("-inf")
        exact += pen.double()
        rec = value_recall(torch, topk_mod, exact, i, 10,
                           1e-5 if dt == torch.float32 else BF16_TOL)
        check(rec == 1.0, f"ragged {dt}: value-recall@10 {rec}")
        errs.append(bm_err)
        print(f"kernel ragged q=37 n=5003 d=200 {str(dt)[6:]}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms; bmax max_abs_err {bm_err:.3g}, scores max "
              f"rel err {s_rel:.3g}, top-10 max_abs_err {v_err:.3g}, "
              f"value-recall@10 {rec}")
    return max(errs)


def phase_kernel_bench(torch, mips, topk_mod, dev):
    q_n, n, d, k = 1024, 1 << 20, 1600, 100
    g = torch.Generator(device=dev).manual_seed(1)
    corpus = torch.empty(n, d, dtype=torch.bfloat16, device=dev)
    for s in range(0, n, 1 << 16):
        rows = torch.randn(1 << 16, d, generator=g, device=dev)
        corpus[s: s + (1 << 16)] = (rows / rows.norm(dim=1, keepdim=True)).bfloat16()
    queries = torch.randn(q_n, d, generator=g, device=dev)
    queries = (queries / queries.norm(dim=1, keepdim=True)).bfloat16()
    bf = torch.bfloat16

    ms = cuda_ms(torch, lambda: mips.scores_with_bucket_max(
        queries, corpus, score_dtype=bf), 5)
    plain_ms = cuda_ms(torch, lambda: mips.scores_with_bucket_max_ref(
        queries, corpus, score_dtype=bf), 3)
    s, bm = mips.scores_with_bucket_max(queries, corpus, score_dtype=bf)
    s_ref, bm_ref = mips.scores_with_bucket_max_ref(queries, corpus, score_dtype=bf)
    torch.cuda.synchronize()
    bm_err = (bm - bm_ref).abs().max().item()
    s_err = max((s[r: r + 64].float() - s_ref[r: r + 64].float()).abs().max().item()
                for r in range(0, q_n, 64))
    v, i = mips.select_topk(s, bm, k)
    v_ref, _ = mips.select_topk(s_ref, bm_ref, k)
    v_err = (v - v_ref).abs().max().item()
    del s, s_ref, bm, bm_ref
    # exact scores of the bf16 rows (products exact in f32): the oracle
    exact, _ = mips.scores_with_bucket_max_ref(queries, corpus)
    rec = value_recall(torch, topk_mod, exact, i, k, BF16_TOL)
    del exact
    tflops = 2 * q_n * n * d / (ms * 1e-3) / 1e12
    # |s| < 1 for unit rows: f32 sums agree to ~1e-6; bf16 ulp at 0.5 is 2^-9
    check(bm_err <= 1e-4, f"bench point: bmax max_abs_err {bm_err}")
    check(s_err <= 2.0**-8, f"bench point: scores max_abs_err {s_err}")
    check(v_err <= 2.0**-8, f"bench point: top-{k} values max_abs_err {v_err}")
    check(rec == 1.0, f"bench point: value-recall@{k} {rec}")
    print(f"kernel bench point q={q_n} n={n} d={d} bf16->bf16: kernel {ms:.3f} ms "
          f"({tflops:.1f} TFLOP/s), plain {plain_ms:.3f} ms; bmax max_abs_err "
          f"{bm_err:.3g}, scores max_abs_err {s_err:.3g}, top-{k} max_abs_err "
          f"{v_err:.3g}, value-recall@{k} {rec}")
    del corpus, queries
    torch.cuda.empty_cache()
    return bm_err, ms, plain_ms


def phase_index(torch, mips, topk_mod, dev):
    from sessionsimilaritysearch_tpu_torch.index.dense import DenseIndex

    n, d, q_n = 1 << 20, 1600, 1024
    idx = DenseIndex(d, n, device=dev, dtype=torch.bfloat16,
                     score_dtype=torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(2)
    t0 = time.perf_counter()
    for _ in range(0, n, 1 << 16):
        rows = torch.randn(1 << 16, d, generator=g, device=dev)
        idx.add(rows / rows.norm(dim=1, keepdim=True))
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    queries = torch.randn(q_n, d, generator=g, device=dev)
    queries = queries / queries.norm(dim=1, keepdim=True)

    mips.launch_count = 0
    D, I = idx.search(queries, 100)  # warm-up
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        D, I = idx.search(queries, 100)  # returns numpy: includes the sync
        times.append(time.perf_counter() - t0)
    launches = mips.launch_count
    check(launches >= 4 * (n // idx.chunk_size), f"index: launch count {launches}")
    check(np.isfinite(D).all() and (np.diff(D, axis=1) <= 0).all(),
          "index: scores not finite and descending")
    check(((I >= 0) & (I < n)).all(), "index: ids out of range")

    # correctness gate: the first 65,536 rows through row_mask, 64 queries,
    # against the f64 numpy oracle over the rows and queries as stored
    sub_n, sub_q = 65536, 64
    mask = torch.arange(n, device=dev) < sub_n
    _, Im = idx.search(queries[:sub_q], 10, row_mask=mask)
    sub = idx.reconstruct_batch(np.arange(sub_n))
    # the queries as search() scores them: cast to bf16, normalized in bf16
    qs = topk_mod.l2_normalize(queries[:sub_q].bfloat16()).float().cpu().numpy()
    check((Im < sub_n).all(), "index: row_mask let a filtered row through")
    rec = topk_mod.value_recall_at_k(Im, qs, sub, 10, rel_tol=BF16_TOL)
    _, i_or = topk_mod.oracle_topk_np(qs, sub, 10)
    set_rec = topk_mod.recall_at_k(Im, i_or)
    check(rec >= 0.999, f"index: value-recall@10 {rec}")

    # the kernel against its plain version on one chunk as search() hands
    # it over: the 1024 queries cast and normalized in bf16, and the first
    # chunk_size stored rows
    bf = torch.bfloat16
    qb = topk_mod.l2_normalize(queries.to(bf)).to(bf).contiguous()
    chunk = idx._buf[: idx.chunk_size]
    s, bm = mips.scores_with_bucket_max(qb, chunk, score_dtype=bf)
    s_ref, bm_ref = mips.scores_with_bucket_max_ref(qb, chunk, score_dtype=bf)
    bm_err = (bm - bm_ref).abs().max().item()
    s_err = (s.float() - s_ref.float()).abs().max().item()
    v, _ = mips.select_topk(s, bm, 100)
    v_ref, _ = mips.select_topk(s_ref, bm_ref, 100)
    v_err = (v - v_ref).abs().max().item()
    # the bench point's tolerances: unit rows, bf16 ulp at 0.5 is 2^-9
    check(bm_err <= 1e-4, f"index chunk: bmax max_abs_err {bm_err}")
    check(s_err <= 2.0**-8, f"index chunk: scores max_abs_err {s_err}")
    check(v_err <= 2.0**-8, f"index chunk: top-100 values max_abs_err {v_err}")
    best = min(times)
    print(f"index 2^20 x 1600 bf16/bf16: fill {fill_s:.2f} s; search 1024 queries "
          f"k=100: {best * 1e3:.1f} ms best of 3 ({q_n / best:.0f} QPS), "
          f"{launches} kernel launches; value-recall@10 {rec} (set recall "
          f"{set_rec}) on the 65,536-row subcorpus; one {idx.chunk_size}-row chunk, "
          f"kernel vs plain: bmax max_abs_err {bm_err:.3g}, scores max_abs_err "
          f"{s_err:.3g}, top-100 max_abs_err {v_err:.3g}")
    del idx, s, s_ref
    torch.cuda.empty_cache()
    return bm_err


def phase_engine(torch, mips, topk_mod, dev):
    import sessionsimilaritysearch_tpu_torch as port
    from sessionsimilaritysearch_tpu_torch.evalharness.harness import EmbeddingPipeline

    cfg = port.Config()
    tok = port.get_tokenizer(cfg.vocab_size)
    t0 = time.perf_counter()
    enc = port.build_graph_encoder(cfg, dev, torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in enc.parameters())
    data = port.SyntheticSessionGenerator(asin_num=cfg.asin_num, seed=0).dataset(8192)
    eng = port.SessionSearchEngine(cfg, tok, enc, dim=cfg.session_emb_dim,
                                   capacity=65536, device=dev)
    eng.embed(data[:8])  # warm-up, counted as set-up: cuBLAS picks its kernels
    setup_s = time.perf_counter() - t0

    mips.launch_count = 0  # count the main path's launches from here
    t0 = time.perf_counter()
    eng.add_sessions(data)
    ingest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    D, I = eng.search(data[:256], k=100)
    search_s = time.perf_counter() - t0
    launches = mips.launch_count

    check(eng.index.ntotal == 8192, f"engine: ntotal {eng.index.ntotal}")
    check(D.shape == (256, 100) and np.isfinite(D).all(), "engine: bad result")
    top1_err = float(np.abs(D[:, 0] - 1.0).max())
    check(top1_err <= 1e-3, f"engine: top-1 score off 1.0 by {top1_err}")
    self_hits = float((I[:, 0] == np.arange(256)).mean())
    check(launches >= 1, "engine: the search never launched the kernel")
    stats = eng.stats()

    # the kernel against its plain version on the engine's own search inputs:
    # the 256 query embeddings normalized as search() does and the stored
    # float32 corpus -- the f32 instantiation at d=1600
    qs = topk_mod.l2_normalize(eng.embed(data[:256], out="device").float()).contiguous()
    corpus = eng.index._buf[: eng.index.ntotal]
    ms = cuda_ms(torch, lambda: mips.scores_with_bucket_max(qs, corpus), 10)
    plain_ms = cuda_ms(torch, lambda: mips.scores_with_bucket_max_ref(qs, corpus), 10)
    s, bm = mips.scores_with_bucket_max(qs, corpus)
    s_ref, bm_ref = mips.scores_with_bucket_max_ref(qs, corpus)
    bm_err = (bm - bm_ref).abs().max().item()
    s_err = (s - s_ref).abs().max().item()
    v, _ = mips.select_topk(s, bm, 100)
    v_ref, _ = mips.select_topk(s_ref, bm_ref, 100)
    v_err = (v - v_ref).abs().max().item()
    d_err = float(np.abs(D - v_ref.cpu().numpy()).max())
    # unit rows, |s| <= 1: two f32 sums over 1600 terms in another order
    check(bm_err <= 1e-5, f"engine: bmax max_abs_err {bm_err}")
    check(s_err <= 1e-5, f"engine: scores max_abs_err {s_err}")
    check(v_err <= 1e-5, f"engine: top-100 values max_abs_err {v_err}")
    check(d_err <= 1e-5, f"engine: search() scores vs plain top-100 max_abs_err {d_err}")

    # the same weights on the CPU: the card must agree in float32 (TF32 off)
    cpu_enc = port.build_graph_encoder(cfg, "cpu", torch.Generator().manual_seed(0))
    cpu_enc.load_state_dict(enc.state_dict())
    on_card = EmbeddingPipeline(cfg, tok, enc, device=dev, batch_size=8)(data[:8])
    on_cpu = EmbeddingPipeline(cfg, tok, cpu_enc, device="cpu", batch_size=8)(data[:8])
    scale = float(np.abs(on_cpu).max())
    enc_err = float(np.abs(on_card - on_cpu).max())
    check(np.isfinite(on_card).all() and enc_err <= 1e-4 * scale,
          f"engine: card vs CPU encoder max_abs_err {enc_err} (scale {scale})")
    print(f"engine Config() ({n_params / 1e6:.1f} M params, 1600-d): setup "
          f"{setup_s:.1f} s; ingest 8192 sessions {ingest_s:.2f} s "
          f"({8192 / ingest_s:.0f} sessions/s); search 256 k=100 {search_s * 1e3:.1f} ms; "
          f"top-1 |score-1| max {top1_err:.3g}, self-hit ids {self_hits:.4f}; "
          f"card vs CPU encoder max_abs_err {enc_err:.3g} of scale {scale:.3g}; "
          f"kernel launches {launches}")
    print(f"engine search shape q=256 n=8192 d=1600 f32->f32, kernel vs plain: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; bmax max_abs_err "
          f"{bm_err:.3g}, scores max_abs_err {s_err:.3g}, top-100 max_abs_err "
          f"{v_err:.3g}, search() top-100 vs plain max_abs_err {d_err:.3g}")
    print(f"engine stats: {json.dumps(stats)}")
    corpus = eng.index.reconstruct_batch(np.arange(eng.index.ntotal))
    return launches, bm_err, (cfg, tok, enc, data, corpus)


def random_signs(torch, g, rows, bits, dev):
    return torch.where(torch.rand(rows, bits, generator=g, device=dev) < 0.5, 1.0, -1.0)


def plain_packed_topk(torch, packed, mips, q, words, k, n_bits, vc=None, pen=None):
    """K4's top-k through its plain version: the same selection and
    distance rule as ``packed.packed_topk``."""
    sd = torch.bfloat16 if n_bits <= 256 else torch.float32
    s, bm = packed.packed_scores_with_bucket_max_ref(q, words, vc, pen, sd)
    return packed.dots_to_hamming(*mips.select_topk(s, bm, k), n_bits)


def sorted_equal(torch, a, b) -> bool:
    return torch.equal(torch.sort(a, dim=1).values, torch.sort(b, dim=1).values)


def packed_case(torch, hamming, g, q_n, n, n_bits, dev):
    """Seeded sign codes: queries +-1 bf16 [q, bits_pad] with zero pad
    columns, the corpus transposed-packed, and the same signs row-major."""
    bits_pad = -(-n_bits // 128) * 128
    corpus = torch.empty(n // 32, bits_pad, dtype=torch.int32, device=dev)
    rows_major = torch.empty(n, -(-n_bits // 32), dtype=torch.int32, device=dev)
    for s in range(0, n, 1 << 16):  # n is a multiple of 2048
        signs = random_signs(torch, g, min(1 << 16, n - s), n_bits, dev)
        corpus[s // 32: (s + len(signs)) // 32] = hamming.pack_bits_t(
            torch.nn.functional.pad(signs, (0, bits_pad - n_bits), value=-1.0))
        rows_major[s: s + len(signs)] = hamming.pack_bits(signs)
    q_signs = random_signs(torch, g, q_n, n_bits, dev)
    q = torch.nn.functional.pad(q_signs, (0, bits_pad - n_bits)).bfloat16()
    return q, corpus, hamming.pack_bits(q_signs), rows_major


def phase_packed_kernel(torch, dev):
    from sessionsimilaritysearch_tpu_torch.ops import hamming, mips, packed

    errs, out = [], {}
    g = torch.Generator(device=dev).manual_seed(3)
    for n_bits in (250, 384):  # bf16 scores, then f32 (codes over 256 bits)
        q, words, _, _ = packed_case(torch, hamming, g, 37, 6144, n_bits, dev)
        pen = torch.where(torch.rand(6144, generator=g, device=dev) < 0.1,
                          float("-inf"), 0.0)
        sd = torch.bfloat16 if n_bits <= 256 else torch.float32
        ms = cuda_ms(torch, lambda: packed.packed_scores_with_bucket_max(
            q, words, 5003, pen, sd), 20)
        plain_ms = cuda_ms(torch, lambda: packed.packed_scores_with_bucket_max_ref(
            q, words, 5003, pen, sd), 20)
        s, bm = packed.packed_scores_with_bucket_max(q, words, 5003, pen, sd)
        s_ref, bm_ref = packed.packed_scores_with_bucket_max_ref(q, words, 5003, pen, sd)
        d, _ = packed.packed_topk(q, words, 10, n_bits, 5003, pen)
        d_ref, _ = plain_packed_topk(torch, packed, mips, q, words, 10, n_bits, 5003, pen)
        # +-1 products are integers: both sides exact, so equal
        check(torch.equal(s, s_ref), f"packed ragged {n_bits} bits: scores differ")
        check(torch.equal(bm, bm_ref), f"packed ragged {n_bits} bits: bmax differs")
        check(torch.equal(d, d_ref), f"packed ragged {n_bits} bits: top-10 distances differ")
        fin = torch.isfinite(s_ref)
        errs.append((s.float()[fin] - s_ref.float()[fin]).abs().max().item())
        print(f"packed kernel ragged q=37 n=6144 {n_bits} bits ({str(sd)[6:]} scores, "
              f"valid_count 5003, 10% masked): kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms; scores, bmax and top-10 distances equal")

    q_n, n, n_bits = 1024, 1 << 20, 256
    q, words, q_rows, c_rows = packed_case(torch, hamming, g, q_n, n, n_bits, dev)
    ms = cuda_ms(torch, lambda: packed.packed_scores_with_bucket_max(q, words), 5)
    plain_ms = cuda_ms(torch, lambda: packed.packed_scores_with_bucket_max_ref(q, words), 3)
    s, bm = packed.packed_scores_with_bucket_max(q, words)
    s_ref, bm_ref = packed.packed_scores_with_bucket_max_ref(q, words)
    check(torch.equal(s, s_ref), "packed bench point: scores differ")
    check(torch.equal(bm, bm_ref), "packed bench point: bmax differs")
    errs.append((bm - bm_ref).abs().max().item())
    del s, s_ref, bm, bm_ref
    d, _ = packed.packed_topk(q, words, 100, n_bits)
    d_ref, _ = plain_packed_topk(torch, packed, mips, q, words, 100, n_bits)
    check(torch.equal(d, d_ref), "packed bench point: top-100 distances differ")
    tflops = 2 * q_n * n * n_bits / (ms * 1e-3) / 1e12
    print(f"packed kernel bench point q={q_n} n={n} {n_bits} bits bf16 scores: kernel "
          f"{ms:.3f} ms ({tflops:.1f} TFLOP/s of +-1 products), plain {plain_ms:.3f} ms; "
          f"scores, bmax and top-100 distances equal")
    torch.cuda.empty_cache()
    out.update(err=max(errs), ms=ms, plain_ms=plain_ms)
    return out, (q_rows, c_rows, d)


def phase_hamming_kernel(torch, dev, bench, k4_ms):
    from sessionsimilaritysearch_tpu_torch.ops import hamming, popcount

    g = torch.Generator(device=dev).manual_seed(3)
    _, _, q, c = packed_case(torch, hamming, g, 37, 6144, 250, dev)
    live = torch.rand(6144, generator=g, device=dev) >= 0.1
    live[5003:] = False
    pen = torch.where(live, 0, popcount.PENALTY).to(torch.int32)
    ms = cuda_ms(torch, lambda: popcount.hamming_bucket_min(q, c, pen), 20)
    plain_ms = cuda_ms(torch, lambda: popcount.hamming_bucket_min_ref(q, c, pen), 5)
    check(torch.equal(popcount.hamming_bucket_min(q, c, pen),
                      popcount.hamming_bucket_min_ref(q, c, pen)),
          "hamming ragged: bmin differs")
    check(torch.equal(popcount.hamming_bucket_min(q, c[:5003]),
                      popcount.hamming_bucket_min_ref(q, c[:5003])),
          "hamming ragged n=5003: bmin differs")
    d, i = hamming.hamming_topk(q, c, 10, valid_count=5003, row_mask=live)
    d_ref, _ = hamming.hamming_topk(q.cpu(), c.cpu(), 10, valid_count=5003,
                                    row_mask=live.cpu())
    check(torch.equal(d.cpu(), d_ref), "hamming ragged: top-10 distances differ")
    check(bool(live[i].all()), "hamming ragged: a dead row ranked")
    print(f"hamming kernel ragged q=37 n=6144 250 bits (valid_count 5003, 10% masked): "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; bmin and top-10 distances equal")

    q, c, d_k4 = bench  # the bench point's codes, row-major
    ms = cuda_ms(torch, lambda: popcount.hamming_bucket_min(q, c), 5)
    plain_ms = cuda_ms(torch, lambda: popcount.hamming_bucket_min_ref(q, c), 1)
    err = (popcount.hamming_bucket_min(q, c)
           - popcount.hamming_bucket_min_ref(q, c)).abs().max().item()
    check(err == 0, f"hamming bench point: bmin max_abs_err {err}")
    popcount.launch_count = 0  # K5's path: the public op hamming_topk
    t0 = time.perf_counter()
    d, _ = hamming.hamming_topk(q, c, 100)
    torch.cuda.synchronize()
    topk_s = time.perf_counter() - t0
    launches = popcount.launch_count
    check(launches >= 1, "hamming_topk never launched the kernel")
    check(sorted_equal(torch, d, d_k4), "hamming_topk and K4 top-100 distances differ")
    print(f"hamming kernel bench point q={q.shape[0]} n={c.shape[0]} 256 bits: kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms, K4 at the same shape {k4_ms:.3f} ms; "
          f"bmin equal; hamming_topk k=100 {topk_s * 1e3:.1f} ms, {launches} launch, "
          f"distances equal K4's")
    del bench, c
    torch.cuda.empty_cache()
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "launches": launches}


def phase_binary_index(torch, dev):
    from sessionsimilaritysearch_tpu_torch.index.binary import BinaryIndex

    n, n_bits, q_n, k = 1 << 20, 250, 1024, 100
    g = torch.Generator(device=dev).manual_seed(4)
    codes = random_signs(torch, g, n, n_bits, dev)
    queries = random_signs(torch, g, q_n, n_bits, dev)
    # the plain version: an f32 product of the +-1 codes, exact for integers
    dots = queries @ codes.T
    want = ((n_bits - torch.topk(dots, k, dim=1).values) * 0.5).to(torch.int32)
    del dots
    for mode in ("packed", "sign"):
        idx = BinaryIndex(n_bits, n, mode, device=dev)
        for s in range(0, n, 1 << 16):
            idx.add(codes[s: s + (1 << 16)])
        d, i = idx.search_device(queries, k)  # warm-up
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            d, i = idx.search(queries, k)  # numpy: includes the sync
            times.append(time.perf_counter() - t0)
        got = torch.from_numpy(d).to(dev)
        check(sorted_equal(torch, got, want), f"binary index {mode}: distances differ")
        check(bool(((i >= 0) & (i < n)).all()), f"binary index {mode}: bad ids")
        ids = torch.from_numpy(i[:, :5]).to(dev)
        true = ((n_bits - (queries[:, None, :] * codes[ids]).sum(-1)) * 0.5).to(torch.int32)
        check(torch.equal(true, got[:, :5]), f"binary index {mode}: ids do not "
              "have their distances")
        best = min(times)
        print(f"binary index {mode} 2^20 x {n_bits} bits: search 1024 queries k={k} "
              f"{best * 1e3:.1f} ms best of 3 ({q_n / best:.0f} QPS); sorted distances "
              f"equal the plain product's")
        del idx
    del codes
    torch.cuda.empty_cache()


def phase_twostage_index(torch, dev):
    from sessionsimilaritysearch_tpu_torch.index.twostage import TwoStageIndex
    from sessionsimilaritysearch_tpu_torch.ops import mips, packed
    from sessionsimilaritysearch_tpu_torch.ops.projection import fit_itq
    from sessionsimilaritysearch_tpu_torch.ops.topk import l2_normalize, rerank_topk

    n, d, q_n, k, pool, n_bits = 1 << 20, 1600, 1024, 100, 128, 250
    g = torch.Generator(device=dev).manual_seed(5)
    rows = torch.empty(n, d, dtype=torch.bfloat16, device=dev)
    for s in range(0, n, 1 << 16):
        r = torch.randn(1 << 16, d, generator=g, device=dev)
        rows[s: s + (1 << 16)] = (r / r.norm(dim=1, keepdim=True)).bfloat16()
    t0 = time.perf_counter()
    proj = fit_itq(rows[: 1 << 15].float().cpu().numpy(), n_bits)
    fit_s = time.perf_counter() - t0
    idx = TwoStageIndex(d, n, device=dev, prefilter="itq", projector=proj,
                        stage1="packed", pool=pool)
    t0 = time.perf_counter()
    for s in range(0, n, 1 << 16):
        idx.add(rows[s: s + (1 << 16)])
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    planted = torch.arange(q_n, device=dev) * (n // q_n) + 7
    # cosine ~0.9 to the planted row: unit row plus noise of norm 0.484
    noise = torch.randn(q_n, d, generator=g, device=dev)
    queries = rows[planted].float() + 0.4843 * noise / noise.norm(dim=1, keepdim=True)

    D, I = idx.search_device(queries, k)  # warm-up
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        D, I = idx.search(queries, k)
        times.append(time.perf_counter() - t0)
    qn = l2_normalize(queries)
    t_s1 = cuda_ms(torch, lambda: idx._stage1(qn, pool), 3)
    cand = idx._stage1(qn, pool)
    t_rr = cuda_ms(torch, lambda: rerank_topk(qn, idx._buf, cand, k), 3)

    # gate 1: stage-1 distances against the plain version
    ci = idx._codes_index
    q_codes = torch.nn.functional.pad(idx._codes(qn), (0, ci.bits_pad - n_bits))
    d1, _ = ci.search_device(idx._codes(qn), pool)
    d1_ref, _ = plain_packed_topk(torch, packed, mips, q_codes, ci._buf, pool, n_bits,
                                  ci.size)
    check(sorted_equal(torch, d1, d1_ref), "two-stage index: stage-1 distances differ")
    # gate 2: the top-k is the exact (f64) re-rank of the pool
    exact = torch.bmm(idx._buf[cand].double(), qn.double()[..., None])[..., 0]
    want = torch.topk(exact, k, dim=1).values
    err = float(np.abs(D - want.cpu().numpy()).max())
    check(err <= 1e-5, f"two-stage index: top-{k} vs exact re-rank of the pool {err}")
    # gate 3: every planted row is the top-1
    hits = float((I[:, 0] == planted.cpu().numpy()).mean())
    check(hits == 1.0, f"two-stage index: planted rows at top-1 {hits}")
    best = min(times)
    print(f"two-stage index 2^20 x {d} bf16, itq {n_bits} bits (fit on 32,768 rows "
          f"{fit_s:.1f} s, fill {fill_s:.2f} s), pool {pool}: search 1024 queries k={k} "
          f"{best * 1e3:.1f} ms best of 3 ({q_n / best:.0f} QPS); stage 1 {t_s1:.3f} ms, "
          f"re-rank {t_rr:.3f} ms (CUDA events); stage-1 distances equal the plain "
          f"version's, top-{k} vs exact re-rank of the pool max_abs_err {err:.3g}, "
          f"planted top-1 {hits}")
    del idx, rows
    torch.cuda.empty_cache()
    return err


def phase_twostage_engine(torch, dev, parts):
    import sessionsimilaritysearch_tpu_torch as port
    from sessionsimilaritysearch_tpu_torch.ops import packed
    from sessionsimilaritysearch_tpu_torch.ops.projection import fit_itq

    cfg, tok, enc, data, corpus = parts
    t0 = time.perf_counter()
    proj = fit_itq(corpus, cfg.code_len)
    fit_s = time.perf_counter() - t0
    eng = port.SessionSearchEngine(cfg, tok, enc, dim=cfg.session_emb_dim,
                                   capacity=65536, device=dev, prefilter="itq",
                                   stage1="packed", projector=proj, pool=512)
    packed.launch_count = 0  # count the path's launches from ingest on
    t0 = time.perf_counter()
    eng.add_sessions(data)
    ingest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    D, I = eng.search(data[:256], k=100)
    search_s = time.perf_counter() - t0
    launches = packed.launch_count
    check(eng.index.ntotal == len(data), f"two-stage engine: ntotal {eng.index.ntotal}")
    check(D.shape == (256, 100) and np.isfinite(D).all(), "two-stage engine: bad result")
    top1_err = float(np.abs(D[:, 0] - 1.0).max())
    check(top1_err <= 2 * 2.0**-8, f"two-stage engine: top-1 score off 1.0 by {top1_err}")
    check(launches >= 1, "two-stage engine: K4 never launched")

    # K4 against its plain version on the engine's own codes
    idx = eng.index
    ci = idx._codes_index
    qn = idx._rows(eng.embed(data[:256], out="device"))  # as search() takes them
    q = torch.nn.functional.pad(idx._codes(qn), (0, ci.bits_pad - ci.n_bits))
    used = -(-ci.size // ci.block_rows) * (ci.block_rows // 32)
    words = ci._buf[:used]
    ms = cuda_ms(torch, lambda: packed.packed_scores_with_bucket_max(q, words, ci.size), 10)
    plain_ms = cuda_ms(torch, lambda: packed.packed_scores_with_bucket_max_ref(
        q, words, ci.size), 10)
    s, bm = packed.packed_scores_with_bucket_max(q, words, ci.size)
    s_ref, bm_ref = packed.packed_scores_with_bucket_max_ref(q, words, ci.size)
    check(torch.equal(s, s_ref) and torch.equal(bm, bm_ref),
          "two-stage engine: K4 differs from its plain version on the engine's codes")
    print(f"two-stage engine Config() itq {ci.n_bits} bits (fit {fit_s:.1f} s), pool 512: "
          f"ingest {len(data)} sessions {ingest_s:.2f} s ({len(data) / ingest_s:.0f} "
          f"sessions/s); search 256 k=100 {search_s * 1e3:.1f} ms; top-1 |score-1| max "
          f"{top1_err:.3g}, self-hit ids {float((I[:, 0] == np.arange(256)).mean()):.4f}; "
          f"K4 launches {launches}; engine's codes q=256 n={used * 32}, kernel {ms:.4f} "
          f"ms vs plain {plain_ms:.4f} ms, scores and bmax equal")
    print(f"two-stage engine stats: {json.dumps(eng.stats())}")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "sessionsimilaritysearch_tpu_torch")):
        print("chip_smoke: run it from the repository (package not found)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    print(f"card: {card[0] if card else 'unknown'}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}, {torch.cuda.get_device_name(0)}")

    from sessionsimilaritysearch_tpu_torch.ops import _build, mips
    from sessionsimilaritysearch_tpu_torch.ops import topk as topk_mod

    print(f"TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn TF32 {torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.load_library()
    info = _build.build_info
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({'compiled' if info else 'reused'} {_build.library_path().name})")
    for line in (info or {}).get("ptxas", []):
        print(f"  {line}")

    from sessionsimilaritysearch_tpu import native
    from sessionsimilaritysearch_tpu_torch import native_build

    native_kind = native_build.ensure_native_library()
    check(native.load() is not None,
          f"the native graph builder did not load ({native_kind} build)")
    print(f"native graph builder: loaded ({native_kind} build)")

    err_ragged = run_phase(torch, "kernel ragged", phase_kernel_ragged,
                           torch, mips, topk_mod, dev)
    err_bench, ms, plain_ms = run_phase(torch, "kernel bench point",
                                        phase_kernel_bench, torch, mips,
                                        topk_mod, dev)
    err_index = run_phase(torch, "index", phase_index, torch, mips, topk_mod, dev)
    launches, err_engine, parts = run_phase(torch, "engine", phase_engine, torch,
                                            mips, topk_mod, dev)
    k4, bench = run_phase(torch, "packed kernel", phase_packed_kernel, torch, dev)
    k5 = run_phase(torch, "hamming kernel", phase_hamming_kernel, torch, dev,
                   bench, k4["ms"])
    del bench
    run_phase(torch, "binary index", phase_binary_index, torch, dev)
    run_phase(torch, "two-stage index", phase_twostage_index, torch, dev)
    k4_launches = run_phase(torch, "two-stage engine", phase_twostage_engine,
                            torch, dev, parts)

    check(not any(m.split(".")[0] in ("jax", "jaxlib", "flax") for m in sys.modules),
          "JAX was imported")
    src = "sessionsimilaritysearch_tpu_torch/csrc/"
    tpu = "sessionsimilaritysearch_tpu/ops/pallas_mips.py:"
    print(json.dumps({"kernels": [
        {"name": "scores_bmax", "route": "cuda", "source": src + "scores_bmax.cu",
         "replaces": tpu + "144", "launches": launches,
         "max_abs_err": max(err_ragged, err_bench, err_index, err_engine),
         "ms": ms, "plain_ms": plain_ms},
        {"name": "packed_scores_bmax", "route": "cuda",
         "source": src + "packed_scores_bmax.cu", "replaces": tpu + "863",
         "launches": k4_launches, "max_abs_err": k4["err"], "ms": k4["ms"],
         "plain_ms": k4["plain_ms"]},
        {"name": "hamming_bucket_min", "route": "cuda",
         "source": src + "hamming_bucket_min.cu", "replaces": tpu + "619",
         "launches": k5["launches"], "max_abs_err": k5["err"], "ms": k5["ms"],
         "plain_ms": k5["plain_ms"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
