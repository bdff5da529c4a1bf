"""Multi-seed retrieval-quality protocol: encoder vs sparse baselines vs
hybrid, with error bars (counterpart of ``examples/quality_protocol.py``).

A large synthetic corpus (default 100k sessions) and N independent seeds,
where each seed draws a fresh product catalog, fresh corpus/query sessions
and a fresh model init. Reported per system: mean +- std (ddof 1) of
``ave_all_product_type_score``@10 across seeds (the reference's default
similarity labeler). The systems: the trained encoder through the default
f32 'cos' ``DenseIndex`` (K1's f32 kernel on the card), SKNN and STAN
(``evaluate_sparse``), the binary and STAN score fusions (``--alpha`` and
each ``--alpha-sweep`` weight) and two reciprocal-rank fusions, computed in
host numpy from the same embeddings.

    python -m sessionsimilaritysearch_tpu_torch.examples.quality_protocol
    python -m sessionsimilaritysearch_tpu_torch.examples.quality_protocol --device cpu \\
        --seeds 2 --corpus 2000 --train 500 --epochs 2

Differences from the JAX script:

- ``--platform {cpu,tpu}`` is ``--device {cuda,cpu}``, default ``cuda``,
  resolved first (``device.resolve_device``): without a card the run raises
  unless ``--device cpu`` is given. The ``--out`` JSON's ``args`` therefore
  hold ``device`` where JAX's hold ``platform``.
- ``main`` returns the ``--out`` document (``args``, ``systems``).
- ``--epochs 0`` runs: the loss no step produced prints as ``nan`` (JAX
  reads ``m['loss']`` from an empty dict there).
- Between seeds ``gc.collect()`` and ``torch.cuda.empty_cache()`` replace
  ``jax.clear_caches()``: nothing is compiled, so only memory is released.
- Random draws: a ``torch.Generator`` seeded with the seed on the device
  (JAX: ``PRNGKey(seed)``) draws the weights and the steps' randomness, so
  the weights differ from JAX's; every numpy stream (the generators' ``1000
  + seed``, the loaders' ``seed`` and ``seed + 1``) is JAX's.
- The flagship encoder's embeddings (bf16 ``serving_params``) reach the
  host as float32, the dtype JAX's index receives.
"""

from __future__ import annotations

import argparse
import gc
import json
import time

import numpy as np
import torch

from sessionsimilaritysearch_tpu_torch.examples.generalization_benchmark import keep_session
from sessionsimilaritysearch_tpu_torch.training.pretrain import (
    create_pretrain_state,
    make_encode_fn,
    make_train_step,
)
from sessionsimilaritysearch_tpu_torch.training.session_trainers import (
    create_session_state,
    make_session_train_step,
)

SIM = "all_product_type_score"


def _disjoint_datasets(gen, n_corpus, n_queries, asins):
    """Corpus sessions from catalog half [0, asins/2), query sessions from
    [asins/2, asins) -- zero item overlap (the out-of-catalog regime of
    ``generalization_benchmark``, whose session filter it uses), same type
    structure."""
    half = asins // 2
    corpus, queries = [], []
    while len(corpus) < n_corpus or len(queries) < n_queries:
        d = gen.datum()
        if len(corpus) < n_corpus and keep_session(d, 0, half):
            corpus.append(d)
        elif len(queries) < n_queries and keep_session(d, half, asins):
            queries.append(d)
    return corpus, queries


def topk_rows(mat, k):
    """The ``k`` largest columns of each row, best first (ties in column
    order of ``argpartition``, as JAX's script)."""
    part = np.argpartition(-mat, k - 1, axis=1)[:, :k]
    vals = np.take_along_axis(mat, part, axis=1)
    return np.take_along_axis(part, np.argsort(-vals, axis=1, kind="stable"), axis=1)


def rrf(sim_a, sim_b, k0=60.0):
    """Reciprocal-rank fusion (Cormack & Clarke '09) of two score matrices."""
    ra = np.empty_like(sim_a, dtype=np.int32)
    rb = np.empty_like(sim_b, dtype=np.int32)
    oa = np.argsort(-sim_a, axis=1, kind="stable")
    ob = np.argsort(-sim_b, axis=1, kind="stable")
    rows = np.arange(sim_a.shape[0])[:, None]
    ra[rows, oa] = np.arange(sim_a.shape[1])[None, :]
    rb[rows, ob] = np.arange(sim_b.shape[1])[None, :]
    return 1.0 / (k0 + ra) + 1.0 / (k0 + rb)


def score_systems(cfg, ce, qe, test_data, corpus_sessions, alpha, alpha_sweep, device,
                  k=10, keep=None) -> dict:
    """Every system's ``ave_all_product_type_score``@k on one seed's
    embeddings ``ce`` (corpus) and ``qe`` (queries), float32 numpy.
    ``keep``: a dict that receives the dense search's index, queries and
    ids, and under ``tops`` each encoder-derived system's top-k ids and
    their scores (I, D)."""
    from sessionsimilaritysearch_tpu_torch.data.similarity import get_ave_score
    from sessionsimilaritysearch_tpu_torch.evalharness.harness import evaluate_sparse
    from sessionsimilaritysearch_tpu_torch.index import sparse as sparse_index
    from sessionsimilaritysearch_tpu_torch.index.dense import build_index

    tops = {}

    def score(name, I, mat=None, D=None):
        tops[name] = (I, np.take_along_axis(mat, I, axis=1) if D is None else D)
        return get_ave_score(I, test_data, corpus_sessions, SIM)

    def fused(name, mat):
        return score(name, topk_rows(mat, k), mat)

    scores = {}
    # dense (trained encoder)
    idx = build_index(ce, metric="cos", device=device)
    D, I = idx.search(qe, k)
    if keep is not None:
        keep.update(index=idx, queries=qe, ids=I, tops=tops)
    scores["encoder"] = score("encoder", I, D=D)
    del idx
    # sparse baselines (SKNN = binary overlap, STAN = time-decayed queries)
    for kind, name in (("binary", "SKNN"), ("stan", "STAN")):
        res = evaluate_sparse(cfg, corpus_sessions, test_data, kind=kind, k=k)
        scores[name] = res.report["ave_all_product_type_score"]
    # hybrid fusion over the embeddings already computed
    cn = ce / np.clip(np.linalg.norm(ce, axis=1, keepdims=True), 1e-9, None)
    qn = qe / np.clip(np.linalg.norm(qe, axis=1, keepdims=True), 1e-9, None)
    sc = sparse_index.build_sparse_corpus(corpus_sessions, cfg.asin_num, kind="binary")
    sq = np.stack([sparse_index.sequence_to_binary_vec(t[0], cfg.asin_num) for t in test_data])
    dense_sim = qn @ cn.T
    bin_sim = np.asarray(sc.dot(sq.T)).T
    scores["hybrid"] = fused("hybrid", alpha * dense_sim + (1 - alpha) * bin_sim)
    # hybrid over the STAN (recency-decayed) overlap: both sides are
    # L2-normalized, so the fusion mixes two cosines on the same scale
    sc_stan = sparse_index.build_sparse_corpus(corpus_sessions, cfg.asin_num, kind="stan")
    sq_stan = np.stack([sparse_index.sequence_to_stan_vec(t[0], cfg.asin_num)
                        for t in test_data])
    stan_sim = np.asarray(sc_stan.dot(sq_stan.T)).T
    scores["hybrid_stan"] = fused("hybrid_stan", alpha * dense_sim + (1 - alpha) * stan_sim)
    # fusion-weight sweep: one argpartition per extra weight
    for a in alpha_sweep:
        for tag, sim in (("hybrid", bin_sim), ("hybrid_stan", stan_sim)):
            name = f"{tag}[a={a:g}]"
            scores[name] = fused(name, a * dense_sim + (1 - a) * sim)
    # reciprocal-rank fusion: rank-based, immune to the two cosines' scales
    for tag, sim in (("rrf_sknn", bin_sim), ("rrf_stan", stan_sim)):
        scores[tag] = fused(tag, rrf(dense_sim, sim))
    return scores


def run_seed(seed: int, args, device, keep=None) -> dict:
    """One full independent trial: fresh catalog, data, and model init.
    ``keep``: a dict that receives the seed's sessions (``corpus``,
    ``test``), embeddings (``ce``, ``qe``), every system's score
    (``scores``), each encoder-derived system's top-k ids and scores
    (``tops``) and the dense search's index, queries and ids."""
    from sessionsimilaritysearch_tpu_torch.config import tiny_test_config
    from sessionsimilaritysearch_tpu_torch.data import (
        AdversarialSessionGenerator,
        SyntheticSessionGenerator,
    )
    from sessionsimilaritysearch_tpu_torch.data.augment import random_exchange_order
    from sessionsimilaritysearch_tpu_torch.data.loader import (
        ContrastiveViewLoader,
        SessionGraphLoader,
    )
    from sessionsimilaritysearch_tpu_torch.evalharness.harness import to_device
    from sessionsimilaritysearch_tpu_torch.tokenizer import get_tokenizer

    dev = device
    cfg = tiny_test_config(
        asin_num=args.asins, gnn_nout=args.gnn_nout, gnn_nhid=args.gnn_nhid,
        emb_len=args.emb_len, text_encoder_dim=args.text_dim,
        batch_size=64, ctv_w=0.5,
    )
    if args.regime == "adversarial":
        gen = AdversarialSessionGenerator(asin_num=args.asins, seed=1000 + seed)
    else:
        gen = SyntheticSessionGenerator(asin_num=args.asins, n_types=args.types,
                                        seed=1000 + seed)
    t0 = time.perf_counter()
    if args.disjoint:
        corpus_data, test_data = _disjoint_datasets(gen, args.corpus, args.queries, args.asins)
        c_items = {a[-1] for d in corpus_data
                   for a in list(d[0]) + list(d[1]) if a[1] != "s"}
        q_items = {a[-1] for d in test_data
                   for a in list(d[0]) + list(d[1]) if a[1] != "s"}
        assert not (c_items & q_items), "catalog halves overlap"
    else:
        corpus_data = gen.dataset(args.corpus)
        test_data = gen.dataset(args.queries)
    train_data = corpus_data[: args.train]
    corpus_sessions = [d[0] for d in corpus_data]
    if keep is not None:
        keep.update(corpus=corpus_data, test=test_data)

    if args.pooling != "srgnn":
        cfg = cfg.replace(product_pooling=args.pooling)
    tok = get_tokenizer(cfg.vocab_size)
    generator = torch.Generator(device=dev).manual_seed(seed)
    m = {}
    if args.encoder == "flagship":
        # the production two-pool encoder under the subsession objective,
        # served in bf16 serving_params (flagship_serving's configuration)
        from sessionsimilaritysearch_tpu_torch.utils.precision import serving_params

        loader = SessionGraphLoader(train_data, tok, cfg.dims, cfg.batch_size,
                                    seed=seed, prefetch=4)
        next(iter(loader))  # JAX's sample batch
        model, state = create_session_state(cfg, dev, mode="subsession",
                                            encoder_kind="flagship", generator=generator)
        step = make_session_train_step(model)
        t_setup = time.perf_counter() - t0

        t0 = time.perf_counter()
        for _ in range(args.epochs):
            for b in loader:
                state, m = step(state, to_device(b, dev))
        loss = float(m["loss"]) if m else float("nan")  # waits for the last step
        t_train = time.perf_counter() - t0
        enc = serving_params(model.encoder)

        def encode_batch(b):
            return enc(to_device(b, dev), deterministic=True)
    else:
        base = SessionGraphLoader(train_data, tok, cfg.dims, cfg.batch_size,
                                  seed=seed, prefetch=4)
        loader = ContrastiveViewLoader(base, random_exchange_order, seed=seed + 1)
        next(iter(loader))  # JAX's sample batch: its view draws come first
        model, state = create_pretrain_state(cfg, dev, generator)
        step = make_train_step(model, has_view=True)
        encode = make_encode_fn(model)
        t_setup = time.perf_counter() - t0

        t0 = time.perf_counter()
        for _ in range(args.epochs):
            for b, v in loader:
                state, m = step(state, to_device(b, dev), to_device(v, dev))
        loss = float(m["loss"]) if m else float("nan")  # waits for the last step
        t_train = time.perf_counter() - t0

        def encode_batch(b):
            return encode(state, to_device(b, dev))

    def embed_all(data):
        out = []
        ld = SessionGraphLoader(data, tok, cfg.dims, cfg.batch_size,
                                shuffle=False, prefetch=2, cache=False)
        with torch.inference_mode():
            for b in ld:
                out.append(encode_batch(b).float().cpu().numpy())
        return np.concatenate(out)[: len(data)]

    t0 = time.perf_counter()
    ce = embed_all([(s, []) for s in corpus_sessions])
    qe = embed_all(test_data)
    t_embed = time.perf_counter() - t0
    del model, state, step

    scores = score_systems(cfg, ce, qe, test_data, corpus_sessions, args.alpha,
                           args.alpha_sweep, dev, keep=keep)
    if keep is not None:
        keep.update(ce=ce, qe=qe, scores=scores)
    print(
        f"seed {seed}: "
        + "  ".join(f"{n}={v:.4f}" for n, v in scores.items())
        + f"   (setup {t_setup:.0f}s train {t_train:.0f}s loss "
        f"{loss:.3f} embed {t_embed:.0f}s)",
        flush=True,
    )
    return scores


def main(argv=None, keep=None) -> dict:
    """Runs the protocol; returns the ``--out`` document. ``keep``: a dict
    whose ``"seeds"`` list receives, per seed, what :func:`run_seed` keeps."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--seed-base", type=int, default=0, help=(
        "offset added to every seed index: run big-budget seeds "
        "one per process and merge (host-OOM isolation)"))
    ap.add_argument("--corpus", type=int, default=100_000)
    ap.add_argument("--train", type=int, default=4000)
    ap.add_argument("--queries", type=int, default=200)
    ap.add_argument("--epochs", type=int, default=15)
    ap.add_argument("--types", type=int, default=25)
    ap.add_argument("--asins", type=int, default=8000)
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--encoder", default="pretrain",
                    choices=["pretrain", "flagship"],
                    help="'flagship' trains the production two-pool "
                         "encoder under the subsession objective instead "
                         "of the pretrain (UnifyPooling) model")
    ap.add_argument("--pooling", default="srgnn",
                    choices=["srgnn", "recency"],
                    help="flagship product readout "
                         "(Config.product_pooling); 'recency' adds the "
                         "learned STAN-style decay stream")
    ap.add_argument("--alpha-sweep", default="",
                    help="comma list of extra fusion weights to score "
                         "(reuses the in-memory similarity matrices)")
    ap.add_argument("--regime", default="clustered",
                    choices=["clustered", "adversarial"],
                    help="'adversarial' = overlap-hostile generator "
                         "(power-law popularity, cross-type trending head, "
                         "hierarchical taxonomy, title synonymy) where SKNN "
                         "is NOT near-oracle")
    # encoder width (session dim = 2*gnn_nout); raise for flagship width
    ap.add_argument("--gnn-nout", type=int, default=64)
    ap.add_argument("--gnn-nhid", type=int, default=64)
    ap.add_argument("--emb-len", type=int, default=48)
    ap.add_argument("--text-dim", type=int, default=64)
    ap.add_argument("--out", default=None, help="write per-seed JSON here")
    ap.add_argument("--disjoint", action="store_true",
                    help="out-of-catalog: corpus/queries from disjoint "
                         "catalog halves (use a smaller --corpus; sessions "
                         "are rejection-sampled)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from sessionsimilaritysearch_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    args.alpha_sweep = [
        float(a) for a in args.alpha_sweep.split(",") if a.strip()
    ]

    all_scores = []
    for s in range(args.seeds):
        kept = None
        if keep is not None:
            kept = {}
            keep.setdefault("seeds", []).append(kept)
        all_scores.append(run_seed(args.seed_base + s, args, dev, keep=kept))
        # release host garbage and the card's cached blocks between trials
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    systems = list(all_scores[0])
    print(
        f"\n=== ave type score@10, {args.seeds} seeds, "
        f"{args.corpus} corpus / {args.queries} queries per seed ==="
    )
    summary = {}
    for name in systems:
        vs = np.array([s[name] for s in all_scores])
        summary[name] = {
            "mean": float(vs.mean()), "std": float(vs.std(ddof=1)),
            "per_seed": [round(float(v), 4) for v in vs],
        }
        print(f"{name:>8}: {vs.mean():.4f} +- {vs.std(ddof=1):.4f}   {vs}")
    report = {"args": vars(args), "systems": summary}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
