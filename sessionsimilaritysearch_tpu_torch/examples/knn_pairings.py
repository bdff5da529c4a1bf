"""Three-pairing kNN next-item evaluation with TRAINED towers (counterpart
of ``examples/knn_pairings.py``; the capability itself is
``harness.evaluate_knn_pairings`` and ``cli evaluate --mode knn``).

The reference builds BOTH a session and a subsession encoder, embeds the
SAME train corpus through each, and logs next-item recall@20 under three
query/db pairings:

    subsession->session, subsession->subsession, session->session

This script reproduces that protocol on the synthetic regimes. The two
towers come from the reference's JOINT trainer -- session + subsession
objectives plus a contrastive loss aligning the two embedding spaces --
which makes the CROSS pairing meaningful; ``--towers joint`` (default)
trains ``training.session_trainers.JointModel``. ``--towers independent``
trains the towers separately as an alignment ablation. Each tower serves
in bf16 ``serving_params``; each pairing is one dense search of the
default f32 'cos' ``DenseIndex`` (K1's f32 kernel on the card).

    python -m sessionsimilaritysearch_tpu_torch.examples.knn_pairings --out pairings.json
    python -m sessionsimilaritysearch_tpu_torch.examples.knn_pairings --device cpu --tiny

Differences from the JAX script:

- ``--platform {cpu,tpu}`` is ``--device {cuda,cpu}``, default ``cuda``,
  resolved first (``device.resolve_device``): without a card the run raises
  unless ``--device cpu`` is given.
- ``main`` returns the ``--out`` document (regime -> the JSON line's dict).
- Random draws: ``torch.Generator`` seeded 1 (the joint pair and the
  subsession tower) and 2 (the session tower) on the device (JAX:
  ``PRNGKey``), so the weights differ from JAX's; every numpy stream (the
  generator's 1000, the loaders' seeds, the joint batches' order and
  ``truncate_to_subsession``) is JAX's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from sessionsimilaritysearch_tpu_torch.training.session_trainers import (
    create_joint_state,
    create_session_state,
    make_joint_train_step,
    make_session_train_step,
)


def run_regime(regime: str, args, device, keep=None) -> dict:
    """Trains the towers on one regime and runs the three pairings; returns
    the JSON line's dict. ``keep``: a dict that receives, per pairing, the
    embeddings and the search's ``D`` / ``I``."""
    from sessionsimilaritysearch_tpu_torch.config import tiny_test_config
    from sessionsimilaritysearch_tpu_torch.data import (
        AdversarialSessionGenerator,
        SyntheticSessionGenerator,
    )
    from sessionsimilaritysearch_tpu_torch.data.graph import (
        build_graph_batch,
        truncate_to_subsession,
    )
    from sessionsimilaritysearch_tpu_torch.data.loader import SessionGraphLoader
    from sessionsimilaritysearch_tpu_torch.evalharness import harness
    from sessionsimilaritysearch_tpu_torch.evalharness.harness import _sync, to_device
    from sessionsimilaritysearch_tpu_torch.tokenizer import get_tokenizer
    from sessionsimilaritysearch_tpu_torch.utils.precision import serving_params

    dev = device
    cfg = tiny_test_config(
        asin_num=args.asins, gnn_nout=args.gnn_nout, gnn_nhid=args.gnn_nhid,
        emb_len=args.emb_len, text_encoder_dim=args.text_dim,
        batch_size=64, ctv_w=0.5,
    ).replace(product_pooling="recency")
    gen = (AdversarialSessionGenerator(asin_num=args.asins, seed=1000)
           if regime == "adversarial"
           else SyntheticSessionGenerator(asin_num=args.asins, seed=1000))
    corpus_data = gen.dataset(args.corpus)
    test_data = gen.dataset(args.queries)
    train_data = corpus_data[: args.train]
    tok = get_tokenizer(cfg.vocab_size)

    def serve(encoder):
        enc = serving_params(encoder)
        return lambda g: enc(g, deterministic=True)

    def train_tower(mode: str, seed: int):
        """One tower under the given objective; returns its encode fn."""
        loader = SessionGraphLoader(train_data, tok, cfg.dims, cfg.batch_size,
                                    seed=seed, prefetch=4)
        next(iter(loader))  # JAX's sample batch
        model, state = create_session_state(
            cfg, dev, mode=mode, encoder_kind="flagship",
            generator=torch.Generator(device=dev).manual_seed(seed))
        step = make_session_train_step(model)
        t0 = time.perf_counter()
        m = {}
        for ep in range(args.epochs):
            for b in loader:
                state, m = step(state, to_device(b, dev))
            _sync(dev)
            print(f"  [{mode} tower] epoch {ep+1}/{args.epochs} "
                  f"t={time.perf_counter()-t0:.0f}s", file=sys.stderr, flush=True)
        loss = float(m.get("loss", np.nan))
        t_train = time.perf_counter() - t0
        return serve(model.encoder), t_train, loss

    def train_joint_towers(seed: int):
        """BOTH towers from the reference's joint trainer: session +
        subsession objectives plus the contrastive alignment that puts the
        two embedding spaces in correspondence."""
        rng_np = np.random.default_rng(seed)
        full = [list(s) + list(t) for s, t in train_data]

        def make_batches(order):
            bs = cfg.batch_size
            for i in range(0, len(order) - bs + 1, bs):  # drop_last
                rows = [full[j] for j in order[i: i + bs]]
                sess = build_graph_batch([(r, r) for r in rows], tok, cfg.dims)
                sub = build_graph_batch(
                    [truncate_to_subsession((r, []), rng_np) for r in rows],
                    tok, cfg.dims)
                yield to_device(sess, dev), to_device(sub, dev)

        t0 = time.perf_counter()
        next(make_batches(np.arange(len(full))))  # JAX's sample batches
        print(f"  [joint towers] first batch built t={time.perf_counter()-t0:.1f}s",
              file=sys.stderr, flush=True)
        model, state = create_joint_state(
            cfg, dev, encoder_kind="flagship",
            generator=torch.Generator(device=dev).manual_seed(seed))
        print(f"  [joint towers] state init t={time.perf_counter()-t0:.1f}s",
              file=sys.stderr, flush=True)
        step = make_joint_train_step(model)
        t0 = time.perf_counter()
        m = {}
        for ep in range(args.epochs):
            order = rng_np.permutation(len(full))
            for bi, (sb, ssb) in enumerate(make_batches(order)):
                state, m = step(state, sb, ssb)
                if ep == 0 and bi in (0, 1, 4, 16, 64):
                    _sync(dev)
                    print(f"  [joint towers] batch {bi} t={time.perf_counter()-t0:.1f}s",
                          file=sys.stderr, flush=True)
            print(f"  [joint towers] epoch {ep+1}/{args.epochs} "
                  f"t={time.perf_counter()-t0:.0f}s loss={float(m['loss']):.4f}",
                  file=sys.stderr, flush=True)
        loss = float(m.get("loss", np.nan))
        t_train = time.perf_counter() - t0
        return (serve(model.subsession_model.encoder), serve(model.session_model.encoder),
                t_train, loss, float(m.get("ctv_loss", np.nan)))

    if args.towers == "joint":
        sub_fn, ses_fn, t_joint, loss_joint, loss_ctv = train_joint_towers(seed=1)
        t_sub = t_ses = round(t_joint / 2, 1)
        loss_sub = loss_ses = loss_joint
    else:
        sub_fn, t_sub, loss_sub = train_tower("subsession", seed=1)
        ses_fn, t_ses, loss_ses = train_tower("session", seed=2)

    t0 = time.perf_counter()
    out = harness.evaluate_knn_pairings(
        cfg, tok, sub_fn, ses_fn, corpus_data, test_data,
        K=args.K, sample_size=args.sample_size, batch_size=cfg.batch_size, device=dev,
        keep=keep,
    )
    t_eval = time.perf_counter() - t0
    out.update({
        "regime": regime, "towers": args.towers,
        "corpus": args.corpus, "train": args.train,
        "queries": args.queries, "epochs": args.epochs,
        "train_s_subsession": round(t_sub, 1),
        "train_s_session": round(t_ses, 1),
        "final_loss_subsession": round(loss_sub, 4),
        "final_loss_session": round(loss_ses, 4),
        "eval_s": round(t_eval, 1),
    })
    if args.towers == "joint":
        out["final_ctv_loss"] = round(loss_ctv, 4)
    print(json.dumps(out), flush=True)
    return out


def main(argv=None, keep=None) -> dict:
    """Runs every regime; returns the ``--out`` document. ``keep``: a dict
    that receives, per regime, what :func:`run_regime` keeps."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--regimes", default="clustered,adversarial")
    ap.add_argument("--towers", default="joint",
                    choices=["joint", "independent"],
                    help=("'joint' = the reference's contrastively aligned "
                          "pair; 'independent' = the alignment ablation"))
    ap.add_argument("--corpus", type=int, default=20_000)
    ap.add_argument("--train", type=int, default=8_000)
    ap.add_argument("--queries", type=int, default=500)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--K", type=int, default=20)
    ap.add_argument("--sample-size", type=int, default=500)
    ap.add_argument("--asins", type=int, default=8000)
    ap.add_argument("--gnn-nout", type=int, default=256)
    ap.add_argument("--gnn-nhid", type=int, default=256)
    ap.add_argument("--emb-len", type=int, default=128)
    ap.add_argument("--text-dim", type=int, default=256)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from sessionsimilaritysearch_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    if args.tiny:
        args.corpus, args.train, args.queries = 512, 256, 32
        args.epochs, args.sample_size, args.asins = 2, 64, 1000
        args.gnn_nout = args.gnn_nhid = 32
        args.emb_len, args.text_dim = 16, 32

    results = {}
    for regime in args.regimes.split(","):
        kept = None
        if keep is not None:
            kept = keep.setdefault(regime.strip(), {})
        results[regime] = run_regime(regime.strip(), args, dev, keep=kept)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
