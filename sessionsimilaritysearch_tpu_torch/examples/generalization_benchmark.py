"""Out-of-catalog generalization benchmark (counterpart of
``examples/generalization_benchmark.py``).

Corpus and query sessions are drawn from DISJOINT halves of the product
catalog (zero item overlap, verified) with a shared product-type structure.
Item-overlap baselines (SKNN/STAN) collapse to chance; the text-driven
session encoder retrieves same-type sessions -- the semantic-similarity
capability this framework provides. The encoder is the pretrain model
(contrastive views), measured untrained and trained through the default
f32 'cos' ``DenseIndex`` (K1's f32 kernel on the card).

    python -m sessionsimilaritysearch_tpu_torch.examples.generalization_benchmark [--epochs 30]
    python -m sessionsimilaritysearch_tpu_torch.examples.generalization_benchmark --device cpu

Differences from the JAX script:

- ``--platform {cpu,tpu}`` is ``--device {cuda,cpu}``, default ``cuda``,
  resolved first (``device.resolve_device``): without a card the run raises
  unless ``--device cpu`` is given.
- ``main`` returns the printed numbers as a dict (``corpus``, ``queries``,
  ``untrained``, ``epochs``, ``train_s``, ``loss``, ``trained``, ``SKNN``,
  ``STAN``).
- ``--epochs 0`` runs: the loss no step produced prints as ``nan`` (JAX
  reads an unbound name there).
- JAX's session filter ``keep`` is :func:`keep_session` here (``main``'s
  ``keep=`` argument takes the name).
- Random draws: ``torch.Generator`` seeded 0 on the device (JAX:
  ``PRNGKey(0)``), so the weights differ from JAX's; every numpy stream
  (the generators' 5 and 12345, the loaders' 0 and 1) is JAX's.
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


def keep_session(d, lo, hi):
    """A session keeps only if every interacted product falls in [lo, hi)."""
    items = [a[-1] for a in (list(d[0]) + list(d[1])) if a[1] != "s"]
    return bool(items) and all(lo <= i < hi for i in items)


def main(argv=None, keep=None) -> dict:
    """Runs the benchmark; returns the printed numbers. ``keep``: a dict
    that receives the sessions (``corpus``, ``test``); its ``"dense"`` list
    receives each dense search's index, query
    embeddings and ids."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--corpus", type=int, default=1500)
    ap.add_argument("--queries", type=int, default=80)
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
    from sessionsimilaritysearch_tpu_torch.evalharness.harness import evaluate_sparse, to_device
    from sessionsimilaritysearch_tpu_torch.index.dense import build_index
    from sessionsimilaritysearch_tpu_torch.tokenizer import get_tokenizer

    cfg = tiny_test_config(
        asin_num=1600, gnn_nout=64, gnn_nhid=64, emb_len=48,
        text_encoder_dim=64, batch_size=64, ctv_w=0.5,
    )
    # same catalog (seed), independent session streams; corpus sessions use
    # only products [0, 800), queries only [800, 1600)
    gen_a = SyntheticSessionGenerator(asin_num=1600, n_types=10, seed=5)
    gen_b = SyntheticSessionGenerator(asin_num=1600, n_types=10, seed=5)
    gen_b.rng = np.random.default_rng(12345)
    corpus_data, test_data = [], []
    while len(corpus_data) < args.corpus:
        d = gen_a.datum()
        if keep_session(d, 0, 800):
            corpus_data.append(d)
    while len(test_data) < args.queries:
        d = gen_b.datum()
        if keep_session(d, 800, 1600):
            test_data.append(d)
    c_items = {a[-1] for d in corpus_data for a in list(d[0]) + list(d[1])
               if a[1] != "s"}
    t_items = {a[-1] for d in test_data for a in list(d[0]) + list(d[1])
               if a[1] != "s"}
    assert not (c_items & t_items), "catalogs must be disjoint"
    print(f"corpus {len(corpus_data)} sessions, queries {len(test_data)}, "
          f"item overlap 0")

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
    out = {"corpus": len(corpus_data), "queries": len(test_data)}

    def embed_all(state, data):
        parts = []
        ld = SessionGraphLoader(data, tok, cfg.dims, cfg.batch_size,
                                shuffle=False, prefetch=2)
        for b in ld:
            parts.append(encode(state, to_device(b, dev)).float().cpu().numpy())
        return np.concatenate(parts)[: len(data)]

    def quality(state, tag, k=10):
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

    out["untrained"] = quality(state, "untrained")
    t0 = time.perf_counter()
    m = {}
    for _ in range(args.epochs):
        for b, v in loader:
            state, m = step(state, to_device(b, dev), to_device(v, dev))
    loss = float(m["loss"]) if m else float("nan")  # waits for the last step
    train_s = time.perf_counter() - t0
    print(f"trained {args.epochs} epochs in {train_s:.0f}s, loss {loss:.3f}")
    out.update(epochs=args.epochs, train_s=train_s, loss=loss)
    out["trained"] = quality(state, "trained")
    for kind, name in (("binary", "SKNN"), ("stan", "STAN")):
        res = evaluate_sparse(cfg, [d[0] for d in corpus_data], test_data,
                              kind=kind, k=10)
        out[name] = res.report["ave_all_product_type_score"]
        print(f"{name}: {out[name]:.3f}")
    return out


if __name__ == "__main__":
    main()
