"""Command-line entry points of the port (counterpart of
``sessionsimilaritysearch_tpu/cli.py``): the same subcommands, flags,
defaults and printed JSON keys, over the port's modules.

    python -m sessionsimilaritysearch_tpu_torch.cli pretrain --epochs 1
    python -m sessionsimilaritysearch_tpu_torch.cli train-subsession --epochs 2
    python -m sessionsimilaritysearch_tpu_torch.cli finetune
    python -m sessionsimilaritysearch_tpu_torch.cli evaluate --mode model
    python -m sessionsimilaritysearch_tpu_torch.cli etl --out data/

(or the ``sss-torch`` console script). JAX's global ``--platform {cpu,tpu}``
becomes ``--device {cuda,cpu}``, default ``cuda``: every subcommand runs on
the card unless ``--device cpu`` is given, and raises where there is no card
(``device.resolve_device``); there is no fallback to the CPU. Synthetic data
is generated when no dataset path is supplied.

The trainers draw their random parts from the train state's generator
(seeded with ``--seed``), which the checkpoints under ``<savedir>/ckpt``
carry: a second call with the same savedir resumes from ``latest.pt``.
``finetune --from-pretrain DIR`` reads DIR's ``config.json`` and the port's
``ckpt/best.pt`` (``latest.pt`` when there is no best); a directory without
them is read as a JAX run's (flax msgpack, ``use_orbax=False``), and an
Orbax checkpoint there raises the reader's ``ValueError``.
"""

from __future__ import annotations

import argparse
import json
import os


def _common(p: argparse.ArgumentParser):
    p.add_argument("--savedir", default="runs/cli")
    p.add_argument("--data", default=None, help="pickled session dataset")
    p.add_argument("--num-sessions", type=int, default=512)
    p.add_argument("--asin-num", type=int, default=2000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiny", action="store_true",
                   help="use the small test config (CPU-friendly)")
    p.add_argument("--batch-size", type=int, default=None)


def _config(args):
    from sessionsimilaritysearch_tpu_torch.config import Config, tiny_test_config

    cfg = tiny_test_config() if args.tiny else Config()
    cfg = cfg.replace(asin_num=args.asin_num, savedir=args.savedir, seed=args.seed)
    if args.batch_size:
        cfg = cfg.replace(batch_size=args.batch_size)
    return cfg


def _dataset(args, cfg):
    from sessionsimilaritysearch_tpu_torch.data.etl import load_sessions
    from sessionsimilaritysearch_tpu_torch.data.synthetic import SyntheticSessionGenerator

    if args.data:
        return load_sessions(args.data)
    gen = SyntheticSessionGenerator(asin_num=cfg.asin_num, seed=cfg.seed)
    return gen.dataset(args.num_sessions)


def text_encoder(cfg, device, seed: int):
    """The randomly initialised text session encoder that ``evaluate`` and
    ``finetune`` embed with: weights drawn from a generator seeded with
    ``seed`` on ``device`` (JAX: ``enc.init(PRNGKey(seed), ...)``). A test
    replaces it to hand the CLI weights carried from JAX."""
    import torch

    from sessionsimilaritysearch_tpu_torch.models import build_text_session_encoder

    return build_text_session_encoder(cfg, device, torch.Generator(device=device).manual_seed(seed))


def _loaders(args, cfg, **train_kw):
    from sessionsimilaritysearch_tpu_torch.data.loader import SessionGraphLoader
    from sessionsimilaritysearch_tpu_torch.tokenizer import get_tokenizer

    data = _dataset(args, cfg)
    n_valid = max(len(data) // 10, 1)
    tok = get_tokenizer(cfg.vocab_size)
    train = SessionGraphLoader(data[n_valid:], tok, cfg.dims, cfg.batch_size, seed=cfg.seed,
                               **train_kw)
    valid = SessionGraphLoader(data[:n_valid], tok, cfg.dims, cfg.batch_size, shuffle=False,
                               **train_kw)
    return train, valid


def _report(best, state):
    print(json.dumps({
        "best_valid_loss": best if best != float("inf") else None,
        "steps": int(state.step),
    }))


def cmd_pretrain(args, device):
    from sessionsimilaritysearch_tpu_torch.training.loop import run_training
    from sessionsimilaritysearch_tpu_torch.training.pretrain import (
        create_pretrain_state,
        make_eval_step,
        make_train_step,
    )
    from sessionsimilaritysearch_tpu_torch.utils.checkpoint import CheckpointManager
    from sessionsimilaritysearch_tpu_torch.utils.logging import RunDir

    cfg = _config(args)
    train_loader, valid_loader = _loaders(args, cfg, ignore_query=cfg.ignore_query)
    use_view = cfg.ctv_w > 0 or args.contrastive
    if use_view and cfg.ctv_w == 0:
        cfg = cfg.replace(ctv_w=0.1)
    model, state = create_pretrain_state(cfg, device)
    step = make_train_step(model, has_view=use_view)
    if use_view:
        from sessionsimilaritysearch_tpu_torch.data.augment import random_exchange_order
        from sessionsimilaritysearch_tpu_torch.data.loader import ContrastiveViewLoader

        train_loader = ContrastiveViewLoader(train_loader, random_exchange_order,
                                             seed=cfg.seed)
        base_step = step

        def step(state, pair):  # adapt (batch, view) tuples
            batch, view = pair
            return base_step(state, batch, view)

    rundir = RunDir(cfg.savedir, cfg, "pretrain")
    ckpt = CheckpointManager(os.path.join(cfg.savedir, "ckpt"))
    state, best = run_training(
        state=state,
        step_fn=step,
        eval_fn=None if use_view else make_eval_step(model),
        train_loader=train_loader,
        valid_loader=None if use_view else valid_loader,
        epochs=args.epochs,
        rundir=rundir,
        ckpt=ckpt,
    )
    _report(best, state)


def cmd_train_session(args, mode: str, device):
    import torch

    from sessionsimilaritysearch_tpu_torch.training.loop import run_training
    from sessionsimilaritysearch_tpu_torch.training.session_trainers import (
        create_session_state,
        make_session_train_step,
    )
    from sessionsimilaritysearch_tpu_torch.utils.checkpoint import CheckpointManager
    from sessionsimilaritysearch_tpu_torch.utils.logging import RunDir

    cfg = _config(args)
    train_loader, valid_loader = _loaders(args, cfg)
    model, state = create_session_state(cfg, device, mode=mode)
    step = make_session_train_step(model)

    def eval_fn(state, batch):
        with torch.no_grad():
            _, m = model(batch, state.generator, deterministic=True)
        return m

    rundir = RunDir(cfg.savedir, cfg, mode)
    ckpt = CheckpointManager(os.path.join(cfg.savedir, "ckpt"))
    state, best = run_training(
        state=state, step_fn=step, eval_fn=eval_fn,
        train_loader=train_loader, valid_loader=valid_loader,
        epochs=args.epochs, rundir=rundir, ckpt=ckpt,
    )
    _report(best, state)


def _pretrained_encode_fn(run_dir: str, device):
    """The frozen encoder of a pretrain run: its config and its best (else
    latest) checkpoint -> (config, ``encode_fn``)."""
    from sessionsimilaritysearch_tpu_torch.config import Config
    from sessionsimilaritysearch_tpu_torch.training.pretrain import (
        create_pretrain_state,
        make_encode_fn,
    )
    from sessionsimilaritysearch_tpu_torch.utils.checkpoint import (
        CheckpointManager,
        read_flax_checkpoint,
        tree_to_state,
    )
    from sessionsimilaritysearch_tpu_torch.weights import load_flax_train_state

    with open(os.path.join(run_dir, "config.json")) as f:
        pcfg = Config.from_json(f.read())
    pmodel, pstate = create_pretrain_state(pcfg, device)
    ckdir = os.path.join(run_dir, "ckpt")
    cm = CheckpointManager(ckdir)
    tree = cm.restore("best" if cm.has("best") else "latest", map_location=device)
    if tree is not None:
        tree_to_state(pstate, tree)
    else:  # a JAX run: flax msgpack; an Orbax checkpoint raises a ValueError
        best = os.path.join(ckdir, "best")
        tag = "best" if os.path.exists(best + ".msgpack") or os.path.isdir(best) else "latest"
        load_flax_train_state(pstate, read_flax_checkpoint(ckdir, tag))
    encode = make_encode_fn(pmodel)
    return pcfg, lambda g: encode(pstate, g)


def cmd_finetune(args, device):
    import numpy as np

    from sessionsimilaritysearch_tpu_torch.data.similarity import mine_triplets
    from sessionsimilaritysearch_tpu_torch.evalharness.harness import EmbeddingPipeline
    from sessionsimilaritysearch_tpu_torch.tokenizer import get_tokenizer
    from sessionsimilaritysearch_tpu_torch.training.finetune import (
        build_triplet_batches,
        create_finetune_state,
        make_finetune_step,
    )
    from sessionsimilaritysearch_tpu_torch.utils.logging import RunDir

    cfg = _config(args)
    data = _dataset(args, cfg)
    half = len(data) // 2
    qdata, db = data[:half], data[half:]
    triplets = mine_triplets(qdata, db, cfg.sim_type, args.num_triplets)
    if not triplets:
        print(json.dumps({"error": "no triplets mined"}))
        return
    tok = get_tokenizer(cfg.vocab_size)

    if args.from_pretrain:
        # frozen encoder = the pretrained graph encoder (the fine_tune_ours wiring)
        pcfg, encode_fn = _pretrained_encode_fn(args.from_pretrain, device)
        emb_dim = pcfg.session_emb_dim
        pipe = EmbeddingPipeline(pcfg, tok, encode_fn, batch_size=pcfg.batch_size,
                                 device=device)
    else:
        # frozen encoder = text session encoder (the fine_tune_QAEA wiring)
        encode_fn = text_encoder(cfg, device, cfg.seed)
        emb_dim = cfg.n_out
        pipe = EmbeddingPipeline(cfg, tok, encode_fn, batch_size=64, device=device)

    model, state = create_finetune_state(cfg, device, emb_dim=emb_dim)
    step = make_finetune_step(model, cfg)
    batches = build_triplet_batches(
        triplets, pipe, [(q[0], list(q[0]) + list(q[1])) for q in qdata[:64]],
        min(cfg.ft_batch_size, len(triplets)), np.random.default_rng(cfg.seed),
        device=device,
    )
    rundir = RunDir(cfg.savedir, cfg, "finetune")
    last = {}
    for epoch in range(args.epochs):
        for b in batches():
            state, last = step(state, b)
        rundir.logger.info(f"epoch {epoch}: loss {float(last['loss']):.4f}")
    print(json.dumps({"final_loss": float(last["loss"]), "triplets": len(triplets)}))


def cmd_evaluate(args, device):
    from sessionsimilaritysearch_tpu_torch.evalharness import harness
    from sessionsimilaritysearch_tpu_torch.tokenizer import get_tokenizer

    if args.mode == "load":
        # recompute the metric suite from a saved search run
        assert args.results, "--mode load requires --results PATH"
        rep = harness.evaluate_loaded(args.results)
        print(json.dumps({"mode": "load",
                          **{k: round(float(v), 4) for k, v in rep.items()}}))
        return

    cfg = _config(args)
    data = _dataset(args, cfg)
    n_test = max(len(data) // 10, 1)
    test_data, corpus_data = data[:n_test], data[n_test:]
    if args.mode in ("STAN", "SKNN"):
        res = harness.evaluate_sparse(
            cfg, [d[0] for d in corpus_data], test_data,
            kind="stan" if args.mode == "STAN" else "binary", k=args.k,
        )
    elif args.mode == "knn":
        tok = get_tokenizer(cfg.vocab_size)
        encode_fn = text_encoder(cfg, device, cfg.seed)
        if args.pairings:
            # the reference's three query/db pairings: a second, independently
            # initialised encoder stands in for the subsession tower
            sub_fn = text_encoder(cfg, device, cfg.seed + 1)
            out = harness.evaluate_knn_pairings(
                cfg, tok, sub_fn, encode_fn, corpus_data, test_data,
                K=args.k, batch_size=64, device=device,
            )
        else:
            out = harness.evaluate_knn_recommendation(
                cfg, tok, encode_fn, corpus_data, test_data, K=args.k,
                batch_size=64, device=device,
            )
        print(json.dumps({"mode": "knn", **{k: round(float(v), 4) for k, v in out.items()}}))
        return
    else:
        tok = get_tokenizer(cfg.vocab_size)
        encode_fn = text_encoder(cfg, device, cfg.seed)
        if args.mode == "hybrid":
            res = harness.evaluate_hybrid(
                cfg, tok, encode_fn, corpus_data, test_data, k=args.k,
                alpha=args.alpha, kind=args.hybrid_kind,
                fusion=args.fusion, batch_size=64, device=device,
            )
        else:
            res = harness.evaluate_encoder(
                cfg, tok, encode_fn, corpus_data, test_data, k=args.k,
                batch_size=64, device=device,
            )
    if args.save_results:
        harness.save_results(
            args.save_results, res.D, res.I, test_data, [d[0] for d in corpus_data],
        )
    out = {
        "mode": args.mode,
        "qps": round(res.qps, 2),
        "search_s": round(res.search_s, 4),
    }
    out.update({k: round(v, 4) for k, v in (res.report or {}).items()})
    print(json.dumps(out))


def cmd_etl(args, device):
    from sessionsimilaritysearch_tpu_torch.data import etl
    from sessionsimilaritysearch_tpu_torch.data.synthetic import SyntheticSessionGenerator

    cfg = _config(args)
    os.makedirs(args.out, exist_ok=True)
    if args.data:
        sessions = etl.load_sessions(args.data)
    else:
        gen = SyntheticSessionGenerator(asin_num=cfg.asin_num, seed=cfg.seed)
        sessions = [gen.session() for _ in range(args.num_sessions)]
    etl.decompose_sessions(
        sessions,
        os.path.join(args.out, "actions.csv"),
        os.path.join(args.out, "asin.csv"),
    )
    back, asin2id = etl.load_sessions_from_csv(
        os.path.join(args.out, "actions.csv"),
        os.path.join(args.out, "asin.csv"),
    )
    print(json.dumps({
        "sessions": len(back),
        "distinct_asins": len(asin2id),
        "out": args.out,
    }))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="sessionsimilaritysearch_tpu_torch")
    parser.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="where every subcommand runs (default: the card; raises without one)",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("pretrain", help="pretrain the flagship encoder")
    _common(p)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--contrastive", action="store_true",
                   help="add the contrastive view objective "
                        "(random_exchange_order augmentation)")

    for mode in ("session", "subsession"):
        p = sub.add_parser(f"train-{mode}", help=f"train the {mode} encoder")
        _common(p)
        p.add_argument("--epochs", type=int, default=1)

    p = sub.add_parser("finetune", help="similarity fine-tune (hash heads)")
    _common(p)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--num-triplets", type=int, default=64)
    p.add_argument("--from-pretrain", default=None,
                   help="savedir of a pretrain run: fine-tune on its frozen "
                        "graph-encoder embeddings (fine_tune_ours wiring)")

    p = sub.add_parser("evaluate", help="end-to-end retrieval evaluation")
    _common(p)
    p.add_argument("--mode", default="model",
                   choices=["model", "STAN", "SKNN", "knn", "load", "hybrid"])
    p.add_argument("--k", type=int, default=20)
    p.add_argument("--alpha", type=float, default=0.5,
                   help="hybrid mode: weight of the dense term")
    p.add_argument("--hybrid-kind", default="overlap", choices=["overlap", "stan"],
                   help="hybrid mode: sparse term (binary overlap or "
                        "recency-decayed STAN weights)")
    p.add_argument("--fusion", default="score", choices=["score", "rrf"],
                   help="hybrid mode: linear score fusion or reciprocal-rank fusion")
    p.add_argument("--pairings", action="store_true",
                   help="knn mode: evaluate the reference's three "
                        "query/db pairings (subsession->session, "
                        "subsession->subsession, session->session) "
                        "instead of the single pairing")
    p.add_argument("--save-results", default=None, metavar="PATH",
                   help="pickle D/I + sessions for later --mode load")
    p.add_argument("--results", default=None, metavar="PATH",
                   help="saved results file for --mode load")

    p = sub.add_parser("etl", help="sessions <-> CSV round trip")
    _common(p)
    p.add_argument("--out", default="data_out")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    from sessionsimilaritysearch_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    if args.cmd == "pretrain":
        cmd_pretrain(args, device)
    elif args.cmd in ("train-session", "train-subsession"):
        cmd_train_session(args, args.cmd.split("-", 1)[1], device)
    elif args.cmd == "finetune":
        cmd_finetune(args, device)
    elif args.cmd == "evaluate":
        cmd_evaluate(args, device)
    elif args.cmd == "etl":
        cmd_etl(args, device)


if __name__ == "__main__":
    main()
