"""Flagship end-to-end serving artifact (counterpart of
``examples/flagship_serving.py``).

One run ties the whole chain together at the reference's operating point:
train the flagship subsession encoder (768/800 -> 1600-d sessions) on
synthetic sessions over the full 391,572-asin catalog, build the catalog
title table and the keyword table, embed a ~1M-session corpus through the
fully cached bf16 forward, and serve the SAME embeddings through every
search mode -- reporting embed throughput, per-mode QPS, value-recall@10
against the oracle and ground-truth retrieval quality (``ave_type_score10``)
from one corpus. The 14 modes: ``exact_bf16`` and ``exact_cert_bf16`` (K1,
the whole corpus as one chunk), ``int8x8_exact`` / ``_cert`` / ``_approx``
(K2), ``pca64_exact`` (K1 at d=64), ``binary_sign`` and ``binary_approx``
(SimHash signs through K1), ``twostage_pool256`` / ``512`` and
``twostage_itq_pool128`` / ``256`` (a sign scan's pool, then the exact
full-dimensional re-rank), ``binary_packed_itq`` and
``twostage_packeditq_pool128`` (the transposed-packed ITQ codes through K4).

    python -m sessionsimilaritysearch_tpu_torch.examples.flagship_serving --out serving.json
    python -m sessionsimilaritysearch_tpu_torch.examples.flagship_serving --cache C  # resumable
    python -m sessionsimilaritysearch_tpu_torch.examples.flagship_serving --device cpu --tiny

``--cache P`` writes ``P.npz`` (``cn``, ``qn``: the normalized corpus and
query embeddings; ``meta``: UTF-8 JSON) and ``P.sessions.pkl`` (the corpus
sessions and the query pairs) after the embed, and a rerun with the same
sessions, regime, catalog and query count resumes at the serving ladder.
The files are the JAX script's layout: a cache either package wrote
resumes in the other (the sessions load through the engine's
``_SessionUnpickler``, so a JAX-written file imports nothing of JAX).

Differences from the JAX script:

- ``--platform {cpu,tpu}`` is ``--device {cuda,cpu}``, default ``cuda``,
  resolved first (``device.resolve_device``): without a card the run raises
  unless ``--device cpu`` is given; nothing falls back to the CPU.
- Timing: each mode runs 3 warm-up calls, then ``--iters`` timed calls
  between two ``torch.cuda.synchronize()`` on the host clock. JAX chains
  each call's output into the next input because the TPU runtime could
  return from ``block_until_ready`` early; the port does not need it.
- The packed modes always run: JAX skips them when its Mosaic kernel is
  unavailable; here K4 launches on the card (or raises) and its plain
  version runs on the CPU.
- No grid padding: JAX pads the packed corpus to a multiple of 16,384 rows
  and the ITQ queries to multiples of 256 rows and 128 bits, its kernels'
  grid multiples. The port's kernels mask: the packed corpus keeps only
  ``pack_bits_t``'s 2048-row blocks and the 128-bit word padding of the
  packed format (250 -> 256 bits), with ``valid_count = N``.
- ``int8x8_approx``, ``binary_approx`` and the ``mode="approx"`` stage 1 of
  the two-stage modes run the port's exact selection (``lax.approx_max_k``
  has no GPU counterpart): their recall can only match or exceed JAX's, and
  ``binary_approx`` returns ``binary_sign``'s ids.
- The oracle bars and the packed two-stage mode's re-score are f32 products
  with TF32 off (``device.py``), where JAX asks for ``Precision.HIGHEST``.
- The corpus embedding is normalized in place, chunk by chunk, and freed
  before the ladder; the cache write copies it to the host in chunks.
- Random draws: ``torch.Generator`` seeded 0 on the device for the
  encoder's weights and the training steps (JAX: ``PRNGKey(0)``), so the
  weights differ from JAX's.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import time
from typing import Optional

import numpy as np
import torch

from sessionsimilaritysearch_tpu_torch.evalharness.harness import _sync

ORACLE_N = 65536  # subcorpus rows of the numpy value-recall oracle
ORACLE_Q = 64  # queries of every oracle gate
BF16_REL = 2 * 2.0**-8  # two bf16 ulps: the bf16-tie band of the cosine gates
INT8_REL = 4 / 127  # int8x8's band: a few code steps of the unit scale


def _timed(fn, q0, iters: int, dev: torch.device):
    """Mean seconds of ``fn(q0)`` over ``iters`` calls after 3 warm-up
    calls, on the host clock between two synchronizations; and the last
    output."""
    for _ in range(3):
        out = fn(q0)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(q0)
    _sync(dev)
    return (time.perf_counter() - t0) / iters, out


def _hamming_vr10(I, q_signs, c_signs, nq: int = ORACLE_Q) -> float:
    """Tie-aware value-recall@10 against the exact full-corpus Hamming
    oracle: a retrieved row counts when its true Hamming distance reaches
    the oracle's 10th best (integer distances tie heavily, so any
    equal-distance row is as good). One f32 product of +-1 codes on the
    codes' device, exact for integers."""
    q = q_signs[:nq].float()
    dist = (q.shape[1] - q @ c_signs.float().T) * 0.5
    bar = torch.kthvalue(dist, 10, dim=1).values[:, None]
    ids = torch.as_tensor(np.asarray(I)[:nq, :10], dtype=torch.int64, device=dist.device)
    got = torch.gather(dist, 1, ids)
    return float((got <= bar + 1e-6).float().mean())


def _fullcorpus_vr10(I, qn, corpus, bars, nq: int = ORACLE_Q,
                     rel_tol: float = BF16_REL) -> float:
    """Value-recall@10 against the full-corpus cosine oracle: a retrieved
    row counts when its true cosine reaches the oracle's 10th best
    (``bars`` [nq, 1], computed from the f32 corpus before it is freed)
    within ``rel_tol``. The rows re-score against the bf16 ``corpus`` in f32
    (TF32 off); its <= 2^-8 relative rounding sits inside the ``rel_tol``
    band. For modes whose candidates cannot be replayed on a subcorpus."""
    ids = torch.as_tensor(np.asarray(I)[:nq, :10], dtype=torch.int64, device=corpus.device)
    rows = corpus[ids].float()                                   # [nq, 10, d]
    got = torch.einsum("qd,qkd->qk", qn[:nq].float(), rows).double().cpu().numpy()
    bar = np.asarray(bars, np.float64)[:nq]
    return float((got >= bar - rel_tol * np.abs(bar)).mean())


def _normalize_rows(x: torch.Tensor, chunk: int = 1 << 16) -> torch.Tensor:
    """``ops.topk.l2_normalize`` of f32 rows, in place, ``chunk`` rows at a
    time (no [N, d] temporary)."""
    from sessionsimilaritysearch_tpu_torch.ops.topk import l2_normalize

    for s in range(0, x.shape[0], chunk):
        x[s: s + chunk] = l2_normalize(x[s: s + chunk])
    return x


def _load_cache(args, cfg):
    """(meta, cn, qn, corpus_sessions, test_data) from a cache that matches
    the requested run, else None."""
    from sessionsimilaritysearch_tpu_torch.engine import _SessionUnpickler

    if not (args.cache and os.path.exists(args.cache + ".npz")):
        return None
    with np.load(args.cache + ".npz") as z:
        cand = json.loads(bytes(z["meta"]).decode())
        if (cand["sessions"] != args.sessions or cand["regime"] != args.regime
                or cand["asin_num"] != cfg.asin_num or cand["queries"] != args.queries):
            print(f"cache mismatch ({cand} vs requested run); rebuilding", flush=True)
            return None
        cn, qn = z["cn"], z["qn"]
    with open(args.cache + ".sessions.pkl", "rb") as f:
        corpus_sessions, test_data = _SessionUnpickler(f).load()
    print(f"cache hit: {args.cache}.npz (skipping generate/train/embed)", flush=True)
    return cand, cn, qn, corpus_sessions, test_data


def main(argv=None, keep: Optional[dict] = None) -> dict:
    """Runs the artifact; returns the report. ``keep``: a dict that receives
    each mode's search (``modes``: name -> (fn, first input)), its ids
    (``ids``: name -> [q, k] numpy) and the serving forms (``forms``), for a
    caller that checks the kernels on them."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=1 << 20)
    ap.add_argument("--train-sessions", type=int, default=12_800)
    ap.add_argument("--train-steps", type=int, default=400)
    ap.add_argument("--asin-num", type=int, default=391_572)
    ap.add_argument("--queries", type=int, default=1024)
    ap.add_argument("--quality-queries", type=int, default=200)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--bits", type=int, default=250)
    ap.add_argument("--embed-batch", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--regime", default="clustered", choices=["clustered", "adversarial"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--cache", default=None, help=(
        "path prefix for a stage checkpoint: the generate/train/embed pipeline saves "
        "its normalized embeddings and sessions here, and a rerun (same sessions, "
        "regime, catalog and queries) resumes straight at the serving ladder"))
    args = ap.parse_args(argv)

    from sessionsimilaritysearch_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)

    from sessionsimilaritysearch_tpu_torch.config import Config, tiny_test_config
    from sessionsimilaritysearch_tpu_torch.data import (
        AdversarialSessionGenerator,
        SyntheticSessionGenerator,
    )
    from sessionsimilaritysearch_tpu_torch.data.loader import SessionGraphLoader
    from sessionsimilaritysearch_tpu_torch.data.similarity import get_ave_score
    from sessionsimilaritysearch_tpu_torch.evalharness.harness import (
        EmbeddingPipeline,
        build_keyword_table,
        build_title_table,
        make_cached_encode_fn,
        to_device,
    )
    from sessionsimilaritysearch_tpu_torch.index.dense import to_host_chunked
    from sessionsimilaritysearch_tpu_torch.ops.hamming import (
        TBLOCK,
        pack_bits_t,
        sign_topk,
        simhash_codes,
    )
    from sessionsimilaritysearch_tpu_torch.ops.mips_int8 import quantize_rows_int8
    from sessionsimilaritysearch_tpu_torch.ops.packed import packed_topk
    from sessionsimilaritysearch_tpu_torch.ops.projection import fit_itq, fit_pca
    from sessionsimilaritysearch_tpu_torch.ops.topk import (
        chunked_topk,
        rerank_topk,
        value_recall_at_k,
    )
    from sessionsimilaritysearch_tpu_torch.tokenizer import get_tokenizer
    from sessionsimilaritysearch_tpu_torch.training.session_trainers import (
        create_session_state,
        make_session_train_step,
    )
    from sessionsimilaritysearch_tpu_torch.utils.precision import serving_params

    if args.tiny:
        cfg = tiny_test_config()
        args.sessions, args.train_sessions = 2048, 256
        args.train_steps, args.queries = 30, 64
        args.quality_queries, args.k = 32, 10
        args.embed_batch, args.iters, args.bits = 128, 2, 32
        args.asin_num = cfg.asin_num
    else:
        cfg = Config().replace(asin_num=args.asin_num, batch_size=256)
    print(f"flagship serving artifact: {args.sessions} sessions, "
          f"session_emb_dim={cfg.session_emb_dim}, asin_num={cfg.asin_num}, "
          f"regime={args.regime}, device={dev}", flush=True)

    # --- 0. stage checkpoint: resume at the serving ladder when a compatible
    # cache exists
    cached = _load_cache(args, cfg)
    if cached is not None:
        meta, cn, qn, corpus_sessions, test_data = cached
        cn = torch.from_numpy(cn).to(dev)
        qn = torch.from_numpy(qn).to(dev)
    else:
        tok = get_tokenizer(cfg.vocab_size)
        gen_cls = (AdversarialSessionGenerator if args.regime == "adversarial"
                   else SyntheticSessionGenerator)
        gen = gen_cls(asin_num=cfg.asin_num, seed=0)

        t0 = time.perf_counter()
        data = gen.dataset(args.sessions)
        test_data = gen.dataset(args.queries)
        t_gen = time.perf_counter() - t0
        print(f"generate: {t_gen:.1f}s", flush=True)

        # --- 1. train the flagship encoder (subsession objective) briefly
        t0 = time.perf_counter()
        bs = min(cfg.batch_size, args.train_sessions)
        train_loader = SessionGraphLoader(data[: args.train_sessions], tok, cfg.dims, bs,
                                          seed=0)
        model, state = create_session_state(
            cfg, dev, mode="subsession", encoder_kind="flagship",
            generator=torch.Generator(device=dev).manual_seed(0))
        step = make_session_train_step(model)
        m, steps = {}, 0
        while steps < args.train_steps:
            for b in train_loader:
                state, m = step(state, to_device(b, dev))
                steps += 1
                if steps >= args.train_steps:
                    break
        train_loader.close()
        loss = float(m["loss"]) if m else float("nan")  # waits for the last step
        t_train = time.perf_counter() - t0
        print(f"train {steps} steps: {t_train:.1f}s, loss {loss:.3f}", flush=True)

        # --- 2. bf16 serving weights, catalog title table, keyword table
        enc = serving_params(model.encoder)
        del model, state
        t0 = time.perf_counter()
        table = build_title_table(cfg, tok, gen.titles, enc, batch_size=args.embed_batch)
        _sync(dev)
        t_table = time.perf_counter() - t0
        print(f"title table [{table.shape[0]} x {table.shape[1]}]: {t_table:.1f}s",
              flush=True)
        # the keywords of the whole corpus: the cached forward then runs no
        # text backbone (a keyword outside the table takes the title-only path)
        t0 = time.perf_counter()
        kws = sorted({a[2] or "" for d in data for a in d[0] if a[1] == "s"})
        qtable, kw_lookup = build_keyword_table(cfg, tok, kws, enc,
                                                batch_size=args.embed_batch)
        _sync(dev)
        t_kw_table = time.perf_counter() - t0
        print(f"keyword table [{qtable.shape[0]} x {qtable.shape[1]}]: {t_kw_table:.1f}s",
              flush=True)
        encode = make_cached_encode_fn(enc, table, query_table=qtable, kw_lookup=kw_lookup)
        pipe = EmbeddingPipeline(cfg, tok, encode, device=dev, batch_size=args.embed_batch)

        # --- 3. embed the corpus on the device (first batch timed apart);
        # every serving form below derives from it there
        corpus_sessions = [d[0] for d in data]
        t0 = time.perf_counter()
        pipe(data[: args.embed_batch], out="device")
        _sync(dev)
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        cn = pipe([(s, []) for s in corpus_sessions], out="device").float()
        _normalize_rows(cn)
        _sync(dev)
        t_embed = time.perf_counter() - t0
        qn = _normalize_rows(pipe(test_data, out="device").float())
        embed_rate = args.sessions / t_embed
        print(f"embed {args.sessions}: {t_embed:.1f}s ({embed_rate:.0f}/s; "
              f"+{t_first:.1f}s first batch)", flush=True)
        del data, pipe, encode, table, qtable, enc
        meta = {
            "sessions": args.sessions, "regime": args.regime,
            "asin_num": cfg.asin_num, "queries": args.queries,
            "gen_s": round(t_gen, 1), "train_steps": steps,
            "train_s": round(t_train, 1), "title_table_s": round(t_table, 1),
            "kw_table_s": round(t_kw_table, 1),
            "embed_s": round(t_embed, 1),
            "embed_sessions_per_s": round(embed_rate, 0),
        }
        if args.cache:
            t0 = time.perf_counter()
            with open(args.cache + ".sessions.pkl", "wb") as f:
                pickle.dump((corpus_sessions, test_data), f, protocol=pickle.HIGHEST_PROTOCOL)
            np.savez(args.cache + ".npz", cn=to_host_chunked(cn), qn=to_host_chunked(qn),
                     meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8))
            print(f"cache saved: {args.cache}.npz ({time.perf_counter() - t0:.1f}s)",
                  flush=True)

    # --- 4. the serving corpus in every storage form, derived on the device
    # from the f32 corpus, which is freed before the ladder
    N, D = cn.shape
    bf16 = torch.bfloat16
    corpus = cn.to(bf16)
    queries = qn.to(bf16)
    c8, c_scales = quantize_rows_int8(cn)
    q8, q_scales = quantize_rows_int8(qn)
    c_signs = simhash_codes(cn, args.bits).to(bf16)
    q_signs = simhash_codes(qn, args.bits).to(bf16)

    K = args.k
    chunk = N  # the whole corpus as one chunk: one kernel launch a search
    oracle_n = min(N, ORACLE_N)
    oracle_q = min(args.queries, ORACLE_Q)
    # the only host views: the oracle slices of the quality gates
    sub = cn[:oracle_n].cpu().numpy()
    subq = qn[:oracle_q].cpu().numpy()

    # PCA low-rank form (value recall against the full-dimensional oracle,
    # explained variance reported), the learned ITQ sign codes, their
    # transposed-packed storage and the full-corpus oracle bars: everything
    # that needs the f32 corpus. The fits sample [65536, D] rows to the host.
    pca_dim = min(64, D)
    proj = fit_pca(cn, pca_dim)
    cp = proj(cn).to(bf16)
    qp = proj(qn).to(bf16)

    t0 = time.perf_counter()
    itq_bits = min(args.bits, D)
    itq = fit_itq(cn, itq_bits)
    t_itq = time.perf_counter() - t0
    i_mean = torch.from_numpy(np.asarray(itq.mean, np.float32)).to(dev)
    i_comp = torch.from_numpy(np.asarray(itq.components, np.float32)).to(dev)

    def itq_signs(x):
        y = (x.float() - i_mean) @ i_comp.T
        return torch.where(y >= 0, 1.0, -1.0).to(bf16)

    ci_signs = itq_signs(cn)
    qi_signs = itq_signs(qn)
    print(f"itq fit: {t_itq:.1f}s ({itq_bits} bits)", flush=True)

    # transposed-packed ITQ codes (BinaryIndex(mode='packed') storage):
    # whole 2048-row pack blocks, words padded to 128 bits; pad bits are 0 in
    # the corpus and 0 in the queries, so they add nothing to a product
    bits_pad = -(-itq_bits // 128) * 128
    n_pack = -(-N // TBLOCK) * TBLOCK
    ci_pad = torch.zeros((n_pack, bits_pad), dtype=torch.float32, device=dev)
    ci_pad[:N, :itq_bits] = ci_signs.float()
    ci_packed = pack_bits_t(ci_pad)
    del ci_pad
    qi_pad = torch.nn.functional.pad(qi_signs, (0, bits_pad - itq_bits)).contiguous()

    # full-corpus cosine oracle bars (10th-best true score per query): f32
    # products with TF32 off (device.py), where JAX asks for HIGHEST
    oracle_bars = torch.topk(qn[:oracle_q] @ cn.T, 10, dim=1).values[:, 9:10].cpu().numpy()
    _sync(dev)
    del cn  # the ladder runs on the derived forms

    modes: dict = {}
    if keep is not None:
        keep["modes"], keep["ids"] = {}, {}
        keep["forms"] = {
            "corpus": corpus, "queries": queries, "c8": c8, "c_scales": c_scales, "q8": q8,
            "c_signs": c_signs, "q_signs": q_signs, "cp": cp, "qp": qp, "ci_signs": ci_signs,
            "qi_signs": qi_signs, "ci_packed": ci_packed, "qi_pad": qi_pad, "n": N}
    nq = args.quality_queries

    def type_score(I):
        return round(get_ave_score(I[:nq, :10], test_data[:nq], corpus_sessions,
                                   "all_product_type_score"), 4)

    def timed_mode(name, fn, q0):
        dt, out = _timed(fn, q0, args.iters, dev)
        I = out[1].cpu().numpy()
        if keep is not None:
            keep["modes"][name] = (fn, q0)
            keep["ids"][name] = I
        return dt, I

    def report(name, dt, I, **extra):
        modes[name] = {"ms_per_batch": round(dt * 1e3, 1),
                       "qps": round(args.queries / dt, 0), **extra,
                       "ave_type_score10": type_score(I)}
        vr = {k: v for k, v in extra.items() if k.startswith("value_recall10")}
        print(f"{name:>26}: {dt * 1e3:7.1f} ms  {args.queries / dt:9,.0f} qps  "
              f"{json.dumps(vr)}  type@10={modes[name]['ave_type_score10']:.4f}", flush=True)

    def run_mode(name, fn, q0, idx_fn, rel_tol):
        dt, I = timed_mode(name, fn, q0)
        vr = value_recall_at_k(idx_fn().cpu().numpy(), subq, sub, 10, rel_tol=rel_tol)
        report(name, dt, I, value_recall10=round(vr, 4))

    sq = queries[:oracle_q]
    run_mode(
        "exact_bf16",
        lambda q: chunked_topk(q, corpus, K, chunk_size=chunk, mode="exact", score_dtype=bf16),
        queries,
        lambda: chunked_topk(sq, corpus[:oracle_n], 10, chunk_size=oracle_n,
                             score_dtype=bf16)[1],
        BF16_REL,
    )
    run_mode(
        "exact_cert_bf16",
        lambda q: chunked_topk(q, corpus, K, chunk_size=chunk, mode="exact_cert",
                               score_dtype=bf16),
        queries,
        lambda: chunked_topk(sq, corpus[:oracle_n], 10, chunk_size=oracle_n,
                             mode="exact_cert", score_dtype=bf16)[1],
        BF16_REL,
    )
    for name, mode in (("int8x8_exact", "exact"), ("int8x8_cert", "exact_cert"),
                       ("int8x8_approx", "approx")):
        run_mode(
            name,
            lambda q, mode=mode: chunked_topk(
                q, c8, K, chunk_size=chunk, mode=mode, recall_target=0.95,
                score_dtype=bf16, corpus_scales=c_scales, query_scales=q_scales),
            q8,
            lambda mode=mode: chunked_topk(
                q8[:oracle_q], c8[:oracle_n], 10, chunk_size=oracle_n, mode=mode,
                recall_target=0.95, score_dtype=bf16, corpus_scales=c_scales[:oracle_n],
                query_scales=q_scales[:oracle_q])[1],
            INT8_REL,
        )

    # --- PCA low-rank serving: value recall against the full-dimensional
    # oracle (are 64-d results as good as 1600-d exact search's?)
    name = f"pca{pca_dim}_exact"
    dt, I = timed_mode(name, lambda q: chunked_topk(q, cp, K, chunk_size=chunk, mode="exact",
                                                    score_dtype=bf16), qp)
    i_sub = chunked_topk(qp[:oracle_q], cp[:oracle_n], 10, chunk_size=oracle_n,
                         score_dtype=bf16)[1]
    vr = value_recall_at_k(i_sub.cpu().numpy(), subq, sub, 10, rel_tol=BF16_REL)
    report(name, dt, I, value_recall10_vs_fulldim=round(vr, 4),
           explained_variance=round(proj.explained, 4))

    # --- binary sign scans, gated by the tie-aware Hamming oracle
    for name, mode in (("binary_sign", "exact"), ("binary_approx", "approx")):
        dt, I = timed_mode(name, lambda q, mode=mode: sign_topk(
            q, c_signs, K, n_bits=args.bits, mode=mode), q_signs)
        report(name, dt, I, value_recall10=round(_hamming_vr10(I, q_signs, c_signs,
                                                               oracle_q), 4),
               value_recall10_oracle="hamming")

    # --- two-stage serving: a sign scan shortlists `pool` candidates, the
    # returned ranking is the exact full-dimensional one over the pool
    # (ops.topk.rerank_topk, f32 scores); SimHash signs, then the learned
    # ITQ signs
    for prefix, pools, cs, qs0, n_bits in (("twostage_pool", (256, 512), c_signs, q_signs,
                                            args.bits),
                                           ("twostage_itq_pool", (128, 256), ci_signs,
                                            qi_signs, itq_bits)):
        for pool in pools:
            def ts_search(qs, p=pool, cs=cs, n_bits=n_bits):
                _, cand = sign_topk(qs, cs, p, n_bits=n_bits, mode="approx",
                                    recall_target=0.95)
                return rerank_topk(queries, corpus, cand, K, score_dtype=torch.float32)

            name = f"{prefix}{pool}"
            dt, I = timed_mode(name, ts_search, qs0)
            _, cand_sub = sign_topk(qs0[:oracle_q], cs[:oracle_n], min(pool, oracle_n),
                                    n_bits=n_bits, mode="approx", recall_target=0.95)
            _, i_sub = rerank_topk(sq, corpus[:oracle_n], cand_sub, 10,
                                   score_dtype=torch.float32)
            vr = value_recall_at_k(i_sub.cpu().numpy(), subq, sub, 10, rel_tol=BF16_REL)
            report(name, dt, I, value_recall10=round(vr, 4))

    # --- the packed tier on trained embeddings: the ITQ codes at 1 bit a bit,
    # scanned by K4: the code scan alone (exact Hamming ranking, the same as
    # binary sign at 1/16th the bytes) and as stage 1 of a two-stage search
    dt, I = timed_mode("binary_packed_itq", lambda q: packed_topk(
        q, ci_packed, K, n_bits=itq_bits, valid_count=N), qi_pad)
    report("binary_packed_itq", dt, I,
           value_recall10=round(_hamming_vr10(I, qi_signs, ci_signs, oracle_q), 4),
           value_recall10_oracle="hamming", hbm_bytes_per_row=bits_pad // 8)

    pool = 128

    def packed_ts(qs, p=pool):
        _, cand = packed_topk(qs, ci_packed, p, n_bits=itq_bits, valid_count=N)
        return rerank_topk(queries, corpus, cand, K, score_dtype=torch.float32)

    name = f"twostage_packeditq_pool{pool}"
    dt, I = timed_mode(name, packed_ts, qi_pad)
    # the packed layout is whole-buffer, so the gate runs against the
    # full-corpus oracle bars
    report(name, dt, I, value_recall10=round(_fullcorpus_vr10(I, qn, corpus, oracle_bars,
                                                              oracle_q), 4))

    result = {
        "sessions": N,
        "dim": D,
        "asin_num": cfg.asin_num,
        "regime": args.regime,
        "k": K,
        "query_batch": args.queries,
        "gen_s": meta["gen_s"],
        "train_steps": meta["train_steps"],
        "train_s": meta["train_s"],
        "title_table_s": meta["title_table_s"],
        "kw_table_s": meta.get("kw_table_s"),
        "itq_fit_s": round(t_itq, 1),
        "embed_s": meta["embed_s"],
        "embed_sessions_per_s": meta["embed_sessions_per_s"],
        "modes": modes,
    }
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
