#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``sessionsimilaritysearch_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernel from ``csrc/`` (nvcc, first use), then:

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

The second-to-last line is a JSON object describing each kernel (launches
counted during phase 4, the main path); the last line is
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
    # warm-up, counted as set-up: in a fresh checkout the first graph batch
    # builds the native graph builder (make), and cuBLAS picks its kernels
    eng.embed(data[:8])
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
    return launches, bm_err


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

    err_ragged = run_phase(torch, "kernel ragged", phase_kernel_ragged,
                           torch, mips, topk_mod, dev)
    err_bench, ms, plain_ms = run_phase(torch, "kernel bench point",
                                        phase_kernel_bench, torch, mips,
                                        topk_mod, dev)
    err_index = run_phase(torch, "index", phase_index, torch, mips, topk_mod, dev)
    launches, err_engine = run_phase(torch, "engine", phase_engine, torch, mips,
                                     topk_mod, dev)

    check(not any(m.split(".")[0] in ("jax", "jaxlib", "flax") for m in sys.modules),
          "JAX was imported")
    print(json.dumps({"kernels": [{
        "name": "scores_bmax",
        "route": "cuda",
        "source": "sessionsimilaritysearch_tpu_torch/csrc/scores_bmax.cu",
        "replaces": "sessionsimilaritysearch_tpu/ops/pallas_mips.py:144",
        "launches": launches,
        "max_abs_err": max(err_ragged, err_bench, err_index, err_engine),
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
