"""Embed-path host/transfer probe (counterpart of
``examples/embed_pipeline_probe.py``).

``EmbeddingPipeline``'s default output (``out='np'``) copies every batch's
[B, 1600] result to the host inside the loop, so the copy serializes with
the next batch's work; ``out='device'`` keeps every batch on the device and
the host waits once, at the end, and an index build then takes the corpus
with no host round trip. At flagship widths (the title + keyword cached
bf16 encoder of the subsession trainer at init, ``Config(asin_num=50,000)``)
over a 100k-session corpus of the adversarial generator (seed 11) it
measures:

- A: the pipeline with ``out='np'``;
- B: the pipeline with ``out='device'``, and the largest |difference| of
  the first 256 rows against A (``parity_max_abs_diff``: the same bf16
  forward on the same batches, so 0);
- C: ``DenseIndex.add`` (bf16, 'cos') from B's device tensor and from A's
  host array.

    python -m sessionsimilaritysearch_tpu_torch.examples.embed_pipeline_probe
    python -m sessionsimilaritysearch_tpu_torch.examples.embed_pipeline_probe --device cpu --tiny

Differences from the JAX script:

- ``--platform {cpu,tpu}`` is ``--device {cuda,cpu}``, default ``cuda``,
  resolved first (``device.resolve_device``); ``platform`` in the report
  becomes ``device`` (the card's name, or ``cpu``).
- B and C end with ``torch.cuda.synchronize()`` on the host clock; JAX
  reads a sum of the result, because the TPU runtime could return from
  ``block_until_ready`` early. B's sum is still checked finite.
- The encoder's weights come from a ``torch.Generator`` seeded 0 on the
  device (JAX: ``PRNGKey(0)``).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from sessionsimilaritysearch_tpu_torch.evalharness.harness import _sync


def main(argv=None, keep=None) -> dict:
    """Runs the probe; returns the report. ``keep``: a dict that receives
    C's two indexes (``index_device``, ``index_np``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=100_000)
    ap.add_argument("--asin-num", type=int, default=50_000)
    ap.add_argument("--embed-batch", type=int, default=1024)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from sessionsimilaritysearch_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)

    from sessionsimilaritysearch_tpu_torch.config import Config, tiny_test_config
    from sessionsimilaritysearch_tpu_torch.data import AdversarialSessionGenerator
    from sessionsimilaritysearch_tpu_torch.evalharness.harness import (
        EmbeddingPipeline,
        build_keyword_table,
        build_title_table,
        make_cached_encode_fn,
    )
    from sessionsimilaritysearch_tpu_torch.index.dense import DenseIndex
    from sessionsimilaritysearch_tpu_torch.tokenizer import get_tokenizer
    from sessionsimilaritysearch_tpu_torch.training.session_trainers import (
        create_session_state,
    )
    from sessionsimilaritysearch_tpu_torch.utils.precision import serving_params

    if args.tiny:
        cfg = tiny_test_config()
        args.sessions, args.embed_batch = 1024, 128
    else:
        cfg = Config().replace(asin_num=args.asin_num, batch_size=256)

    gen = AdversarialSessionGenerator(asin_num=cfg.asin_num, seed=11)
    data = [d[0] for d in gen.dataset(args.sessions)]
    tok = get_tokenizer(cfg.vocab_size)

    # the flagship serving encoder at init (bf16, cached tables): the
    # serving soak's recipe; quality does not matter to this probe
    model, _ = create_session_state(cfg, dev, mode="subsession", encoder_kind="flagship",
                                    generator=torch.Generator(device=dev).manual_seed(0))
    enc = serving_params(model.encoder)
    del model
    table = build_title_table(cfg, tok, gen.titles, enc, batch_size=args.embed_batch)
    kws = sorted({a[2] or "" for d in data for a in d if a[1] == "s"})
    qtable, kw_lookup = build_keyword_table(cfg, tok, kws, enc, batch_size=args.embed_batch)
    encode = make_cached_encode_fn(enc, table, query_table=qtable, kw_lookup=kw_lookup)
    pipe = EmbeddingPipeline(cfg, tok, encode, device=dev, batch_size=args.embed_batch)

    # both outputs once outside the timed region
    pipe(data[: args.embed_batch])
    pipe(data[: args.embed_batch], out="device")
    _sync(dev)

    report = {"sessions": len(data), "embed_batch": args.embed_batch,
              "dim": cfg.session_emb_dim,
              "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}

    # A: a blocking host copy every batch
    t0 = time.perf_counter()
    emb_np = pipe(data)
    a_s = time.perf_counter() - t0
    report["A_np_s"] = round(a_s, 2)
    report["A_np_sessions_per_s"] = round(len(data) / a_s, 0)

    # B: on the device, one wait at the end
    t0 = time.perf_counter()
    emb_dev = pipe(data, out="device")
    _sync(dev)
    b_s = time.perf_counter() - t0
    report["B_device_s"] = round(b_s, 2)
    report["B_device_sessions_per_s"] = round(len(data) / b_s, 0)
    report["B_speedup_vs_A"] = round(a_s / b_s, 2)
    if not np.isfinite(float(emb_dev.float().sum())):
        raise FloatingPointError("the device embeddings hold a non-finite value")

    # parity: the same rows (the bf16 forward is deterministic on both paths)
    head = emb_dev[:256].float().cpu().numpy()
    report["parity_max_abs_diff"] = float(np.max(np.abs(head - emb_np[:256])))

    # C: the index build from the device tensor, and from the host array
    idx = DenseIndex(dim=cfg.session_emb_dim, capacity=len(data), metric="cos",
                     dtype=torch.bfloat16, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    idx.add(emb_dev)
    _sync(dev)
    report["C_add_device_s"] = round(time.perf_counter() - t0, 2)
    idx2 = DenseIndex(dim=cfg.session_emb_dim, capacity=len(data), metric="cos",
                      dtype=torch.bfloat16, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    idx2.add(emb_np)
    _sync(dev)
    report["C_add_np_s"] = round(time.perf_counter() - t0, 2)
    if keep is not None:
        keep.update(index_device=idx, index_np=idx2)

    print(json.dumps(report, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
