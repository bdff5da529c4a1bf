"""In-catalog retrieval quality benchmark: trained encoder vs sparse
baselines vs hybrid fusion (counterpart of ``examples/incatalog_benchmark.py``).

In-catalog (shared product catalog between corpus and queries) is SKNN's
home turf: the synthetic type clusters correlate perfectly with item
overlap, which is the exact signal SKNN matches on. The hybrid mode
(``evalharness.harness.evaluate_hybrid``) fuses the learned embedding cosine
with that overlap cosine on the host. The dense rows go through the default
f32 'cos' ``DenseIndex`` (K1's f32 kernel on the card).

    python -m sessionsimilaritysearch_tpu_torch.examples.incatalog_benchmark [--epochs 30]
    python -m sessionsimilaritysearch_tpu_torch.examples.incatalog_benchmark --device cpu

Differences from the JAX script:

- ``--platform {cpu,tpu}`` is ``--device {cuda,cpu}``, default ``cuda``,
  resolved first (``device.resolve_device``): without a card the run raises
  unless ``--device cpu`` is given.
- ``main`` returns the printed numbers as a dict (``encoder untrained``,
  ``epochs``, ``train_s``, ``loss``, ``encoder trained``, ``SKNN``,
  ``STAN``, ``hybrid``, ``alpha``).
- ``--epochs 0`` runs: the loss no step produced prints as ``nan`` (JAX
  reads ``m['loss']`` from an empty dict there).
- Random draws: ``torch.Generator`` seeded 0 on the device (JAX:
  ``PRNGKey(0)``), so the weights differ from JAX's; every numpy stream
  (the generator's 5, the loaders' 0 and 1) is JAX's.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from sessionsimilaritysearch_tpu_torch.training.pretrain import (
    create_pretrain_state,
    make_encode_fn,
    make_train_step,
)


def main(argv=None, keep=None) -> dict:
    """Runs the benchmark; returns the printed numbers. ``keep``: a dict
    that receives the sessions (``corpus``, ``test``); its ``"dense"`` list
    receives each dense search's index, query
    embeddings and ids, and ``hybrid_D`` / ``hybrid_ids`` the hybrid
    top-k."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--corpus", type=int, default=2000)
    ap.add_argument("--queries", type=int, default=100)
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from sessionsimilaritysearch_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)

    from sessionsimilaritysearch_tpu_torch.config import tiny_test_config
    from sessionsimilaritysearch_tpu_torch.data import SyntheticSessionGenerator
    from sessionsimilaritysearch_tpu_torch.data.augment import random_exchange_order
    from sessionsimilaritysearch_tpu_torch.data.loader import (
        ContrastiveViewLoader,
        SessionGraphLoader,
    )
    from sessionsimilaritysearch_tpu_torch.data.similarity import get_ave_score
    from sessionsimilaritysearch_tpu_torch.evalharness.harness import (
        evaluate_hybrid,
        evaluate_sparse,
        to_device,
    )
    from sessionsimilaritysearch_tpu_torch.index.dense import build_index
    from sessionsimilaritysearch_tpu_torch.tokenizer import get_tokenizer

    cfg = tiny_test_config(
        asin_num=1600, gnn_nout=64, gnn_nhid=64, emb_len=48,
        text_encoder_dim=64, batch_size=64, ctv_w=0.5,
    )
    gen = SyntheticSessionGenerator(asin_num=1600, n_types=10, seed=5)
    corpus_data = gen.dataset(args.corpus)
    test_data = gen.dataset(args.queries)

    if keep is not None:
        keep.update(corpus=corpus_data, test=test_data)
    tok = get_tokenizer(cfg.vocab_size)
    base = SessionGraphLoader(corpus_data, tok, cfg.dims, cfg.batch_size,
                              seed=0, prefetch=4)
    loader = ContrastiveViewLoader(base, random_exchange_order, seed=1)
    next(iter(loader))  # JAX's sample batch: its view draws come first
    model, state = create_pretrain_state(cfg, dev, torch.Generator(device=dev).manual_seed(0))
    step = make_train_step(model, has_view=True)
    encode = make_encode_fn(model)
    out = {}

    def embed_all(state, data):
        parts = []
        ld = SessionGraphLoader(data, tok, cfg.dims, cfg.batch_size,
                                shuffle=False, prefetch=2, cache=False)
        for b in ld:
            parts.append(encode(state, to_device(b, dev)).float().cpu().numpy())
        return np.concatenate(parts)[: len(data)]

    def dense_quality(state, tag, k=10):
        ce = embed_all(state, [(d[0], []) for d in corpus_data])
        qe = embed_all(state, test_data)
        idx = build_index(ce, metric="cos", device=dev)
        _, I = idx.search(qe, k)
        s = get_ave_score(I, test_data, [d[0] for d in corpus_data],
                          "all_product_type_score")
        print(f"{tag}: ave type score@{k} = {s:.3f}")
        if keep is not None:
            keep.setdefault("dense", []).append(
                {"tag": tag, "index": idx, "queries": qe, "ids": I})
        return s

    out["encoder untrained"] = dense_quality(state, "encoder untrained")
    t0 = time.perf_counter()
    m = {}
    for _ in range(args.epochs):
        for b, v in loader:
            state, m = step(state, to_device(b, dev), to_device(v, dev))
    loss = float(m["loss"]) if m else float("nan")  # waits for the last step
    train_s = time.perf_counter() - t0
    print(f"trained {args.epochs} epochs in {train_s:.0f}s, loss {loss:.3f}")
    out.update(epochs=args.epochs, train_s=train_s, loss=loss)
    out["encoder trained"] = dense_quality(state, "encoder trained")

    for kind, name in (("binary", "SKNN"), ("stan", "STAN")):
        res = evaluate_sparse(cfg, [d[0] for d in corpus_data], test_data,
                              kind=kind, k=10)
        out[name] = res.report["ave_all_product_type_score"]
        print(f"{name}: {out[name]:.3f}")

    def enc_fn(g):
        return encode(state, g)

    res = evaluate_hybrid(cfg, tok, enc_fn,
                          [(d[0], []) for d in corpus_data], test_data,
                          k=10, alpha=args.alpha, batch_size=cfg.batch_size, device=dev)
    out["hybrid"] = res.report["ave_all_product_type_score"]
    out["alpha"] = args.alpha
    print(f"hybrid (alpha={args.alpha}): {out['hybrid']:.3f}")
    if keep is not None:
        keep.update(hybrid_D=res.D, hybrid_ids=res.I)
    return out


if __name__ == "__main__":
    main()
