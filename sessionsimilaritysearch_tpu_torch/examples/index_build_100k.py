"""End-to-end 100k-session index build and serve (counterpart of
``examples/index_build_100k.py``).

Generate 100k synthetic sessions, train the subsession encoder briefly,
embed the whole corpus with bf16 serving weights through the native
whole-batch graph construction, build the exact flat index (the default f32
'cos' ``DenseIndex``, K1's f32 kernel) and answer 1,000 top-100 queries:
the reference's build-then-serve pipeline as one script.

    python -m sessionsimilaritysearch_tpu_torch.examples.index_build_100k
    python -m sessionsimilaritysearch_tpu_torch.examples.index_build_100k --device cpu --tiny

Differences from the JAX script:

- ``--platform {cpu,tpu}`` is ``--device {cuda,cpu}``, default ``cuda``,
  resolved first (``device.resolve_device``): without a card the run raises
  unless ``--device cpu`` is given.
- ``embed_compile_s`` becomes ``embed_first_batch_s``: the port compiles
  nothing, and the first batch's time is what remains of the split.
- The serve half (serving weights -> encode -> index -> search) is the
  function :func:`serve`, which ``main`` calls.
- Random draws: ``torch.Generator`` seeded 0 on the device (JAX:
  ``PRNGKey(0)``), so the weights differ from JAX's.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from sessionsimilaritysearch_tpu_torch.evalharness.harness import _sync


def serve(cfg, tok, encoder, data, queries: int, k: int, embed_batch: int, device,
          keep=None) -> dict:
    """The serve half: ``encoder`` (a trained encoder module) in bf16
    serving weights (``utils.precision.serving_params``) through the
    uncached forward, the whole corpus ``data`` embedded by
    ``EmbeddingPipeline``, the default f32 'cos' ``DenseIndex`` built on it,
    and the first ``queries`` embeddings searched at depth ``k`` (one warm
    search, one timed). Returns the times and ``D`` / ``I`` (numpy).
    ``keep``: a dict that receives the index, the query embeddings and the
    ids."""
    from sessionsimilaritysearch_tpu_torch.evalharness.harness import EmbeddingPipeline
    from sessionsimilaritysearch_tpu_torch.index.dense import DenseIndex
    from sessionsimilaritysearch_tpu_torch.utils.precision import serving_params

    dev = torch.device(device)
    enc = serving_params(encoder)

    def encode(g):
        return enc(g, deterministic=True)

    pipe = EmbeddingPipeline(cfg, tok, encode, device=dev, batch_size=embed_batch)
    # the first batch timed apart from the steady throughput of the build
    t0 = time.perf_counter()
    pipe(data[:embed_batch])
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    emb = pipe([d[0] for d in data], out="device")
    _sync(dev)
    t_embed = time.perf_counter() - t0

    t0 = time.perf_counter()
    index = DenseIndex(dim=emb.shape[1], capacity=len(data), metric="cos", device=dev)
    index.add(emb)
    _sync(dev)
    t_build = time.perf_counter() - t0
    q = emb[:queries]
    index.search(q, k)  # warm
    t0 = time.perf_counter()
    D, I = index.search(q, k)
    t_search = time.perf_counter() - t0
    if keep is not None:
        keep.update(index=index, queries=q, ids=I)
    return {"embed_s": t_embed, "embed_first_batch_s": t_first, "index_build_s": t_build,
            "search_s": t_search, "D": D, "I": I}


def main(argv=None, keep=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=100_000)
    ap.add_argument("--train-sessions", type=int, default=10_000)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--queries", type=int, default=1000)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--embed-batch", type=int, default=2048)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)

    from sessionsimilaritysearch_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)

    from sessionsimilaritysearch_tpu_torch.config import Config, tiny_test_config
    from sessionsimilaritysearch_tpu_torch.data import SyntheticSessionGenerator
    from sessionsimilaritysearch_tpu_torch.data.loader import SessionGraphLoader
    from sessionsimilaritysearch_tpu_torch.evalharness.harness import to_device
    from sessionsimilaritysearch_tpu_torch.tokenizer import get_tokenizer
    from sessionsimilaritysearch_tpu_torch.training.session_trainers import (
        create_session_state,
        make_session_train_step,
    )

    if args.tiny:
        cfg = tiny_test_config()
        args.sessions = min(args.sessions, 512)
        args.train_sessions = min(args.train_sessions, 128)
        args.queries = min(args.queries, 32)
        args.embed_batch = 64
    else:
        cfg = Config(
            asin_num=20_000, vocab_size=8192, text_encoder_dim=256,
            query_embedder_nhid=512, gnn_nhid=256, gnn_nout=256,
            emb_len=128, qh_nhead=4, batch_size=512,
        )
    tok = get_tokenizer(cfg.vocab_size)
    gen = SyntheticSessionGenerator(asin_num=cfg.asin_num, seed=0)

    t0 = time.perf_counter()
    data = gen.dataset(args.sessions)
    t_gen = time.perf_counter() - t0
    print(f"generate {args.sessions} sessions: {t_gen:.1f}s", flush=True)

    # --- train briefly (subsession objective)
    t0 = time.perf_counter()
    train_loader = SessionGraphLoader(data[: args.train_sessions], tok, cfg.dims,
                                      min(cfg.batch_size, args.train_sessions), seed=0)
    model, state = create_session_state(cfg, dev, mode="subsession",
                                        generator=torch.Generator(device=dev).manual_seed(0))
    step = make_session_train_step(model)
    m = {}
    for _ in range(args.epochs):
        for b in train_loader:
            state, m = step(state, to_device(b, dev))
    train_loader.close()
    loss = float(m["loss"]) if m else float("nan")  # waits for the last step
    t_train = time.perf_counter() - t0
    print(f"train {args.epochs} epochs on {args.train_sessions}: {t_train:.1f}s, "
          f"loss {loss:.3f}", flush=True)

    # --- embed the corpus with bf16 serving weights, index, serve
    r = serve(cfg, tok, model.encoder, data, args.queries, args.k, args.embed_batch, dev,
              keep=keep)
    print(f"embed {args.sessions}: {r['embed_s']:.1f}s "
          f"({args.sessions / r['embed_s']:.0f} sessions/s; "
          f"+{r['embed_first_batch_s']:.1f}s first batch)", flush=True)
    D, I = r["D"], r["I"]
    # briefly trained encoders can be near-degenerate (candidates closer
    # than score precision), so report both the set metric and the value
    # metric: the top-1 score must be within rounding of the exact
    # self-cosine 1.0 whenever an equally close tie displaces the query's row
    self_top1 = float((I[:, 0] == np.arange(len(I))).mean())
    top1_at_self = float((D[:, 0] >= 1.0 - 1e-4).mean())
    summary = {
        "sessions": args.sessions,
        "gen_s": round(t_gen, 1),
        "train_s": round(t_train, 1),
        "embed_s": round(r["embed_s"], 1),
        "embed_first_batch_s": round(r["embed_first_batch_s"], 1),
        "embed_sessions_per_s": round(args.sessions / r["embed_s"], 0),
        "index_build_s": round(r["index_build_s"], 2),
        "search_s": round(r["search_s"], 3),
        "qps": round(args.queries / r["search_s"], 0),
        "self_recall_at_1": self_top1,
        "top1_score_at_self_cos": top1_at_self,
    }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
