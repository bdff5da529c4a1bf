"""Epoch-scale training soak (counterpart of ``examples/training_soak.py``).

Every pretrain head of the loss menu -- next / all-product sampled-negative
BCE, next / all-query and next / all-title text-embedding heads, QAEA
distillation, query / product node reconstruction, token ELECTRA -- and the
contrastive-view objective, on together at the reference's widths
(768 / 800 -> 1600-d, asin_num=391,572), through the production
``training.loop.run_training`` with a mid-run checkpoint and resume and a
forced NaN drill. The reference leaves its auxiliary weights at 0, so the
soak uses uniform small ones (0.1, contrastive view 0.5).

The drill poisons the batch's query -> product adjacency (``adj_qp``) with
NaN at step ``--nan-step``: the GAT's softmax carries it into the session
embedding, so every head's loss is non-finite that step, and
``run_training`` drops the update. The soak checks that the parameters and
statistics after the drop equal those from before the poisoned step, bit for
bit. Phase 1a trains with a checkpoint, phase 1b without one (the work a
crash loses; the drill lands there), and phase 2 resumes a fresh state from
the checkpoint and finishes. The exit code is 1 unless the drill was caught
and rolled back bit for bit and the resume went past the checkpoint.

    python -m sessionsimilaritysearch_tpu_torch.examples.training_soak --sessions 500000
    python -m sessionsimilaritysearch_tpu_torch.examples.training_soak --device cpu --tiny

Differences from the JAX script: ``--platform`` is ``--device {cuda,cpu}``,
default ``cuda``, resolved first (``device.resolve_device``; no fallback to
the CPU); the port's ``run_training`` calls ``step_fn(state, batch)`` (the
draws come from the train state's generator, which the checkpoint carries),
so the instrumented step takes no ``rng``; the ``nan_caught`` event lists
the loss terms that stayed finite (``finite_terms``, empty when the poison
reached every head), and a ``rollback_checked`` event says whether the
rollback was ``bit_exact``, which the exit code also asks; ``--savedir``
defaults to ``soak_run`` in the temporary directory
(``tempfile.gettempdir()``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from sessionsimilaritysearch_tpu_torch.config import Config, tiny_test_config
from sessionsimilaritysearch_tpu_torch.data import SyntheticSessionGenerator
from sessionsimilaritysearch_tpu_torch.data.augment import random_exchange_order
from sessionsimilaritysearch_tpu_torch.data.loader import (
    ContrastiveViewLoader,
    SessionGraphLoader,
)
from sessionsimilaritysearch_tpu_torch.device import resolve_device
from sessionsimilaritysearch_tpu_torch.tokenizer import get_tokenizer
from sessionsimilaritysearch_tpu_torch.training.loop import run_training
from sessionsimilaritysearch_tpu_torch.training.pretrain import (
    create_pretrain_state,
    make_train_step,
)
from sessionsimilaritysearch_tpu_torch.utils.checkpoint import CheckpointManager
from sessionsimilaritysearch_tpu_torch.utils.logging import RunDir

SOAK_WEIGHTS = dict(ph_w=0.1, qh_w=0.1, pt_w=0.1, qaea_w=0.1, node_w=0.1, token_w=0.1,
                    ctv_w=0.5)


class _Limited:
    """The first ``limit`` items of a fresh iterable from ``mk``."""

    def __init__(self, mk, limit):
        self.mk, self.limit = mk, limit

    def __iter__(self):
        n = 0
        for item in self.mk():
            if n >= self.limit:
                return
            yield item
            n += 1


def _tensors(state) -> dict:
    model = state.model
    return {**dict(model.named_parameters()), **dict(model.named_buffers())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=500_000)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--asin-num", type=int, default=391_572)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--nan-step", type=int, default=None,
                    help="inject a poisoned batch at this step (default: mid-epoch)")
    ap.add_argument("--resume-at", type=int, default=None,
                    help="simulate a crash: stop after this many steps, then restart "
                         "from the checkpoint (default: ~2/3 of the first epoch)")
    ap.add_argument("--savedir", default=os.path.join(tempfile.gettempdir(), "soak_run"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    weights = SOAK_WEIGHTS
    if args.tiny:
        cfg = tiny_test_config(**weights)
        args.sessions, args.batch_size = 256, 16
        args.asin_num = cfg.asin_num
    else:
        cfg = Config().replace(asin_num=args.asin_num, batch_size=args.batch_size, **weights)
    steps_per_epoch = args.sessions // args.batch_size
    nan_step = args.nan_step or max(2, steps_per_epoch // 2)
    resume_at = args.resume_at or max(3, (2 * steps_per_epoch) // 3)
    print(f"soak: {args.sessions} sessions x {args.epochs} epochs "
          f"({steps_per_epoch} steps/epoch, batch {args.batch_size}), "
          f"session_emb_dim={cfg.session_emb_dim}, "
          f"asin_num={cfg.asin_num}; NaN drill at step {nan_step}, "
          f"simulated crash after step {resume_at}", flush=True)

    tok = get_tokenizer(cfg.vocab_size)
    gen = SyntheticSessionGenerator(asin_num=cfg.asin_num, seed=0)
    t0 = time.perf_counter()
    data = gen.dataset(args.sessions)
    print(f"generate: {time.perf_counter()-t0:.1f}s", flush=True)

    def fresh_loader():
        base = SessionGraphLoader(data, tok, cfg.dims, args.batch_size, seed=0, prefetch=4)
        return ContrastiveViewLoader(base, random_exchange_order, seed=1)

    model, state = create_pretrain_state(cfg, dev)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"params: {n_params/1e6:.1f}M", flush=True)

    # --- instrumented step: wall time, loss log, NaN injection, and the
    # bit-for-bit check of the rollback the loop makes after the drill
    times, losses, events = [], [], []
    counter = {"step": 0}
    check = {}  # the state and its tensors from before the poisoned step

    def check_rollback():
        if check:
            live = _tensors(check["state"])
            exact = all(torch.equal(live[k], v) for k, v in check["before"].items())
            events.append({"step": check["step"], "event": "rollback_checked",
                           "bit_exact": exact})
            check.clear()

    def instrumented(raw_step):
        def step_fn(state, batch):
            check_rollback()
            b, v = batch
            counter["step"] += 1
            if counter["step"] == nan_step:
                # poison the query -> product adjacency: the GAT softmax carries
                # it into the session embedding, so every head's loss goes
                # non-finite this step (adj_pp does not: its gating masks NaN)
                b = b._replace(adj_qp=b.adj_qp.float() * float("nan"))
                events.append({"step": counter["step"], "event": "nan_injected"})
                check.update(state=state, step=counter["step"], before={
                    k: t.detach().clone() for k, t in _tensors(state).items()})
            t0 = time.perf_counter()
            new_state, m = raw_step(state, b, v)
            loss = float(m["loss"])  # waits for the step
            dt = time.perf_counter() - t0
            if np.isfinite(loss):
                times.append(dt)
                losses.append(loss)
            else:
                # the loss terms the poison did not reach (none, when it
                # reached every head)
                finite = sorted(k for k, x in m.items() if bool(torch.isfinite(x).all()))
                events.append({"step": counter["step"], "event": "nan_caught",
                               "finite_terms": finite})
            return new_state, m

        return step_fn

    ckpt = CheckpointManager(os.path.join(args.savedir, "ckpt"))
    rundir = RunDir(os.path.join(args.savedir, "logs"), cfg)
    step_fn = instrumented(make_train_step(model, has_view=True))

    # --- phase 1a: train to half the simulated crash point, checkpointing
    t0 = time.perf_counter()
    half = resume_at // 2
    state, _ = run_training(
        state=state, step_fn=step_fn, train_loader=_Limited(fresh_loader, half),
        epochs=1, ckpt=ckpt, rundir=rundir, resume=False,
    )
    # phase 1b: no checkpoint -- the work a real crash loses (the NaN drill
    # lands here; with no checkpoint the loop drops the poisoned update)
    state, _ = run_training(
        state=state, step_fn=step_fn, train_loader=_Limited(fresh_loader, resume_at - half),
        epochs=1, ckpt=None, rundir=rundir, resume=False,
    )
    check_rollback()
    crash_step = int(state.step)
    events.append({"step": crash_step, "event": "simulated_crash"})
    print(f"simulated crash at trained step {crash_step} "
          f"({time.perf_counter()-t0:.0f}s so far)", flush=True)
    del model, state, step_fn
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # --- phase 2: a fresh state resumes from the checkpoint and finishes
    # the epoch(s), as a restarted job does
    model2, state2 = create_pretrain_state(cfg, dev)
    state2, _ = run_training(
        state=state2, step_fn=instrumented(make_train_step(model2, has_view=True)),
        train_loader=_Limited(fresh_loader, steps_per_epoch * args.epochs - resume_at + half),
        epochs=1, ckpt=ckpt, rundir=rundir, resume=True,
    )
    check_rollback()
    resumed_from = half  # the only checkpoint is phase 1a's epoch end
    total = time.perf_counter() - t0
    ts = np.asarray(times)
    # the first steps (allocator warm-up, lazy initialisation) can dwarf the
    # steady ones: report steady-state percentiles and the count excluded
    steady = ts[ts < 5 * np.median(ts)] if len(ts) else ts
    n_warm = len(ts) - len(steady)
    result = {
        "sessions": args.sessions,
        "epochs": args.epochs,
        "batch_size": args.batch_size,
        "asin_num": cfg.asin_num,
        "session_emb_dim": cfg.session_emb_dim,
        "params_m": round(n_params / 1e6, 1),
        "loss_weights": weights,
        "steps_total": int(state2.step),
        "wall_s": round(total, 1),
        "sessions_per_s": round(args.batch_size * len(steady) / steady.sum(), 0),
        "step_ms_p50": round(float(np.percentile(steady, 50)) * 1e3, 1),
        "step_ms_p90": round(float(np.percentile(steady, 90)) * 1e3, 1),
        "step_ms_p99": round(float(np.percentile(steady, 99)) * 1e3, 1),
        "compile_steps_excluded": int(n_warm),
        "loss_first20": round(float(np.mean(losses[:20])), 4),
        "loss_last20": round(float(np.mean(losses[-20:])), 4),
        "events": events,
        "loss_curve_every50": [round(float(x), 4) for x in losses[::50]],
    }
    print(json.dumps(result), flush=True)
    ok_drill = (any(e["event"] == "nan_caught" for e in events)
                and all(e["bit_exact"] for e in events if e["event"] == "rollback_checked")
                and any(e["event"] == "rollback_checked" for e in events))
    ok_resume = int(state2.step) > resumed_from
    print(f"NaN drill caught+rolled back: {ok_drill}; "
          f"resumed from step {resumed_from} -> {int(state2.step)}: "
          f"{ok_resume}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0 if ok_drill and ok_resume else 1


if __name__ == "__main__":
    sys.exit(main())
