"""Trained binary-code quality: dense cosine vs 250-bit Hamming serving on
the SAME encoder embeddings (counterpart of ``examples/binary_quality.py``).

The reference's hashing serve path fine-tunes BinarizeHeads over frozen
session embeddings, packs sign codes and serves them with a flat binary
index, reporting the ave similarity of the Hamming top-k next to the dense
top-k. This reproduces that comparison end to end: train an encoder
(contrastive pretrain objective), fine-tune 250-bit hash heads (alternating
towers, triplet + pair losses, ``training/finetune.py``), then retrieve the
same query set through dense cosine (the default f32 'cos' ``DenseIndex``,
K1's f32 kernel on the card) and four code families through
``evaluate_binary(mode='sign')`` (K1 on +-1 bf16 rows: the ``cp_async``
variant at 250 bits) -- untrained heads, SimHash, ITQ and the trained
heads -- reporting ``ave_all_product_type_score``@k for each plus Hamming
QPS. ``--flagship`` sets the reference's widths: 800 / 800 / 768 / 200,
i.e. 1600-d sessions, a 6.4:1 compression to 250 bits.

    python -m sessionsimilaritysearch_tpu_torch.examples.binary_quality [--flagship]
    python -m sessionsimilaritysearch_tpu_torch.examples.binary_quality --device cpu \\
        --corpus 800 --train 300 --queries 40 --epochs 2 --ft-epochs 2 --bits 32

Differences from the JAX script:

- ``--platform {cpu,tpu}`` is ``--device {cuda,cpu}``, default ``cuda``,
  resolved first (``device.resolve_device``): without a card the run raises
  unless ``--device cpu`` is given.
- ``main`` returns the printed numbers as a dict.
- The Hamming QPS is the port's ``evaluate_binary`` search on the host
  clock (the index build excluded), as JAX's is ("host-measured").
- Random draws: ``torch.Generator`` seeded ``--seed`` (the encoder) and
  ``--seed + 7`` (the hash heads) on the device (JAX: ``PRNGKey``), so the
  weights differ from JAX's; every numpy stream (the generator, the
  loaders, ``mine_triplets``, the triplet batches, SimHash and ITQ) is
  JAX's.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from sessionsimilaritysearch_tpu_torch.training.finetune import (
    build_triplet_batches,
    create_finetune_state,
    make_code_fns,
    make_finetune_step,
)
from sessionsimilaritysearch_tpu_torch.training.pretrain import (
    create_pretrain_state,
    make_encode_fn,
    make_train_step,
)


def spectrum(ce: np.ndarray) -> dict:
    """Effective dimensionality of the embeddings: the participation ratio
    of the centred covariance spectrum (on at most 8,192 rows) and the
    variance share of its top 10, 50 and 250 directions."""
    cen = ce - ce.mean(0, keepdims=True)
    sv = np.linalg.svd(cen[: min(len(cen), 8192)], compute_uv=False)
    lam = sv.astype(np.float64) ** 2
    top = lam / lam.sum()
    return {"participation_ratio": float(lam.sum() ** 2 / (lam**2).sum()),
            "var_top10": float(top[:10].sum()), "var_top50": float(top[:50].sum()),
            "var_top250": float(top[:250].sum())}


def main(argv=None, keep=None) -> dict:
    """Runs the study; returns the printed numbers. ``keep``: a dict that
    receives the sessions (``corpus``, ``test``), the embeddings (``ce``,
    ``qe``), the dense search's index, queries and ids, the mined triplets
    and each Hamming row's codes and search (``codes``: tag -> (db codes,
    query codes, D, I))."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", type=int, default=20_000)
    ap.add_argument("--train", type=int, default=3000)
    ap.add_argument("--queries", type=int, default=200)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--ft-epochs", type=int, default=20)
    ap.add_argument("--bits", type=int, default=250)
    ap.add_argument("--triplets", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--types", type=int, default=25)
    ap.add_argument("--asins", type=int, default=8000)
    ap.add_argument("--seed", type=int, default=0)
    # encoder width: session_emb_dim = 2*gnn_nout. --flagship sets the
    # reference's operating point: 800/768 => 1600-d sessions, a 6.4:1
    # compression to 250 bits
    ap.add_argument("--flagship", action="store_true")
    ap.add_argument("--gnn-nout", type=int, default=64)
    ap.add_argument("--gnn-nhid", type=int, default=64)
    ap.add_argument("--emb-len", type=int, default=48)
    ap.add_argument("--text-dim", type=int, default=64)
    ap.add_argument("--regime", default="clustered",
                    choices=["clustered", "adversarial"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from sessionsimilaritysearch_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    if args.flagship:
        args.gnn_nout = args.gnn_nhid = 800
        args.text_dim = 768
        args.emb_len = 200

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
    from sessionsimilaritysearch_tpu_torch.data.similarity import get_ave_score, mine_triplets
    from sessionsimilaritysearch_tpu_torch.evalharness.harness import (
        EmbeddingPipeline,
        _sync,
        evaluate_binary,
        to_device,
    )
    from sessionsimilaritysearch_tpu_torch.index.dense import build_index
    from sessionsimilaritysearch_tpu_torch.ops.hamming import simhash_codes
    from sessionsimilaritysearch_tpu_torch.ops.projection import fit_itq, itq_codes
    from sessionsimilaritysearch_tpu_torch.tokenizer import get_tokenizer

    cfg = tiny_test_config(
        asin_num=args.asins, gnn_nout=args.gnn_nout, gnn_nhid=args.gnn_nhid,
        emb_len=args.emb_len, text_encoder_dim=args.text_dim,
        batch_size=64, ctv_w=0.5, code_len=args.bits,
    )
    if args.regime == "adversarial":
        gen = AdversarialSessionGenerator(asin_num=args.asins, seed=args.seed)
    else:
        gen = SyntheticSessionGenerator(asin_num=args.asins, n_types=args.types,
                                        seed=args.seed)
    corpus_data = gen.dataset(args.corpus)
    test_data = gen.dataset(args.queries)
    mine_data = gen.dataset(args.triplets * 2)
    corpus_sessions = [d[0] for d in corpus_data]
    if keep is not None:
        keep.update(corpus=corpus_data, test=test_data)
    tok = get_tokenizer(cfg.vocab_size)
    out = {"session_emb_dim": cfg.session_emb_dim, "bits": args.bits,
           "compression": cfg.session_emb_dim / args.bits, "regime": args.regime}
    print(f"session_emb_dim={cfg.session_emb_dim} -> {args.bits} bits "
          f"(compression {cfg.session_emb_dim/args.bits:.1f}:1), "
          f"regime={args.regime}", flush=True)

    # --- 1. train the session encoder (contrastive pretrain objective)
    base = SessionGraphLoader(corpus_data[: args.train], tok, cfg.dims,
                              cfg.batch_size, seed=args.seed, prefetch=4)
    loader = ContrastiveViewLoader(base, random_exchange_order, seed=args.seed + 1)
    next(iter(loader))  # JAX's sample batch: its view draws come first
    model, state = create_pretrain_state(
        cfg, dev, torch.Generator(device=dev).manual_seed(args.seed))
    step = make_train_step(model, has_view=True)
    encode = make_encode_fn(model)
    t0 = time.perf_counter()
    for _ in range(args.epochs):
        for b, v in loader:
            state, _ = step(state, to_device(b, dev), to_device(v, dev))
    _sync(dev)
    out["encoder_train_s"] = time.perf_counter() - t0
    print(f"encoder trained: {args.epochs} epochs, {out['encoder_train_s']:.0f}s")

    pipe = EmbeddingPipeline(cfg, tok, lambda g: encode(state, g), device=dev,
                             batch_size=cfg.batch_size)
    ce = pipe([(s, []) for s in corpus_sessions])
    qe = pipe(test_data)

    # effective dimensionality of the embeddings: the honest context for
    # any "X% retained at B bits" claim
    spec = spectrum(ce)
    out.update(spec)
    print(f"embedding spectrum: dim={ce.shape[1]} "
          f"participation_ratio={spec['participation_ratio']:.1f} "
          f"var_top10={spec['var_top10']:.3f} var_top50={spec['var_top50']:.3f} "
          f"var_top250={spec['var_top250']:.4f}", flush=True)

    # --- 2. dense cosine baseline on the same embeddings
    idx = build_index(ce, metric="cos", device=dev)
    _, I = idx.search(qe, args.k)
    dense_score = get_ave_score(I, test_data, corpus_sessions, "all_product_type_score")
    if keep is not None:
        keep.update(ce=ce, qe=qe, index=idx, queries=qe, ids=I, codes={})
    del idx

    # --- 3. fine-tune the hash heads over the frozen embeddings
    triplets = mine_triplets(mine_data, corpus_data[:2000], "all_product_type_score",
                             args.triplets, pos_thresh=0.6, half_lo=0.1)
    print(f"mined {len(triplets)} triplets")
    out["triplets"] = len(triplets)
    if keep is not None:
        keep["triplets"] = triplets
    ft_model, ft_state = create_finetune_state(
        cfg, dev, emb_dim=ce.shape[1], shared_init=True,  # start at LSH quality
        generator=torch.Generator(device=dev).manual_seed(args.seed + 7))
    db_fn, q_fn = make_code_fns(ft_model)
    ce_t = torch.as_tensor(ce, device=dev)
    qe_t = torch.as_tensor(qe, device=dev)
    code_db0 = db_fn(ft_state, ce_t).cpu().numpy()
    code_q0 = q_fn(ft_state, qe_t).cpu().numpy()

    step_fn = make_finetune_step(ft_model, cfg)
    batches = build_triplet_batches(
        triplets, pipe, [(q[0], q[0]) for q in mine_data[:64]],
        min(32, max(4, len(triplets) // 4)), np.random.default_rng(args.seed), device=dev,
    )
    t0 = time.perf_counter()
    m = {}
    for _ in range(args.ft_epochs):
        for b in batches():
            ft_state, m = step_fn(ft_state, b)
    out["ft_loss"] = float(m.get("loss", float("nan")))
    out["ft_train_s"] = time.perf_counter() - t0
    print(f"hash heads trained: {args.ft_epochs} epochs, {out['ft_train_s']:.0f}s"
          f" (loss {out['ft_loss']:.4f})")

    # --- 4. Hamming serving: untrained vs trained vs learned-projection
    # codes. ITQ is the gradient-free learned construction (center + PCA +
    # balanced rotation fitted on the corpus embeddings only)
    lsh_db = simhash_codes(ce, args.bits, seed=args.seed)
    lsh_q = simhash_codes(qe, args.bits, seed=args.seed)
    itq_bits = min(args.bits, ce.shape[1])
    itq_proj = fit_itq(ce, itq_bits, seed=args.seed)
    rows = [("dense cosine", dense_score, None)]
    for tag, db_c, q_c in (
        ("binary untrained", code_db0, code_q0),
        ("binary LSH (simhash)", lsh_db, lsh_q),
        (f"binary ITQ ({itq_bits}b)", itq_codes(ce, itq_proj), itq_codes(qe, itq_proj)),
        ("binary trained", db_fn(ft_state, ce_t).cpu().numpy(),
         q_fn(ft_state, qe_t).cpu().numpy()),
    ):
        res = evaluate_binary(db_c, q_c, corpus_sessions, test_data, k=args.k, mode="sign",
                              device=dev)
        rows.append((tag, res.report["ave_all_product_type_score"], res.qps))
        if keep is not None:
            keep["codes"][tag] = (db_c, q_c, res.D, res.I)
    out["rows"] = {tag: {"score": s, "qps": qps} for tag, s, qps in rows}
    print(f"\n=== ave type score@{args.k}, {args.corpus} corpus, "
          f"{args.bits}-bit codes ===")
    for tag, s, qps in rows:
        extra = f"  ({qps:,.0f} qps host-measured)" if qps else ""
        kept = f"  [{100*s/dense_score:.1f}% of dense]" if tag != rows[0][0] else ""
        print(f"{tag:>22}: {s:.4f}{kept}{extra}")
    return out


if __name__ == "__main__":
    main()
