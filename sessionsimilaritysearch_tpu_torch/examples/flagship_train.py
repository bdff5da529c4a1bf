"""Flagship-scale training run (counterpart of ``examples/flagship_train.py``).

Runs pretrain or subsession training at the reference's widths -- gnn 800 /
text 768 (=> 1600-d session embedding) with the full asin_num=391,572
embedding table and ~1000 sampled negatives a step -- on the card, measuring
the first step, the steady step time and the loss curve, then proving
checkpoint + resume: a fresh state re-enters ``run_training``, which
restores the saved ``latest`` checkpoint, and continues from the saved step
for ``--resume-steps`` more batches.

    python -m sessionsimilaritysearch_tpu_torch.examples.flagship_train --phase pretrain --steps 200
    python -m sessionsimilaritysearch_tpu_torch.examples.flagship_train --phase subsession --steps 200
    python -m sessionsimilaritysearch_tpu_torch.examples.flagship_train --device cpu --steps 4 ...

It generates ``steps * batch + batch`` sessions, so the loader (no
``drop_last``, the last batch wrap-padded) yields ``steps + 1`` batches, as
JAX's does: the summary's ``steps`` is that count.

Differences from the JAX script:

- ``--platform`` (JAX: whatever ``jax.devices()[0]`` is) is ``--device
  {cuda,cpu}``, default ``cuda``, resolved first (``device.resolve_device``):
  without a card the run raises unless ``--device cpu`` is given.
- ``compile_step_s`` becomes ``first_step_s`` (the first step, its kernels'
  first launches included) and ``platform`` becomes ``device`` (the card's
  name, or ``cpu``), as the flagship campaign's summary does.
- ``--savedir`` defaults to ``flagship_run`` in the temporary directory
  (``tempfile.gettempdir()``; JAX: ``/tmp/flagship_run``).
- The step's random draws come from the train state's generator (seeded
  with ``--seed`` on the device), so the losses differ from JAX's.
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


def make_config(args):
    """The run's ``Config``: the reference's widths with the flags' catalog,
    batch, save directory and seed."""
    from sessionsimilaritysearch_tpu_torch.config import Config

    return Config().replace(asin_num=args.asin_num, batch_size=args.batch_size,
                            savedir=args.savedir, seed=args.seed)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", choices=["pretrain", "subsession"], default="pretrain")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--resume-steps", type=int, default=20,
                    help="steps for the follow-up resume-proof run")
    ap.add_argument("--batch-size", type=int, default=50)
    ap.add_argument("--asin-num", type=int, default=391_572)
    ap.add_argument("--savedir", default=os.path.join(tempfile.gettempdir(), "flagship_run"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from sessionsimilaritysearch_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)

    from sessionsimilaritysearch_tpu_torch.data.loader import SessionGraphLoader
    from sessionsimilaritysearch_tpu_torch.data.synthetic import SyntheticSessionGenerator
    from sessionsimilaritysearch_tpu_torch.tokenizer import get_tokenizer
    from sessionsimilaritysearch_tpu_torch.training.loop import run_training
    from sessionsimilaritysearch_tpu_torch.utils.checkpoint import CheckpointManager
    from sessionsimilaritysearch_tpu_torch.utils.logging import RunDir

    cfg = make_config(args)
    savedir = os.path.join(args.savedir, args.phase)
    os.makedirs(savedir, exist_ok=True)

    n_sessions = args.steps * cfg.batch_size + cfg.batch_size
    print(f"# generating {n_sessions} sessions over a {cfg.asin_num}-asin catalog ...",
          file=sys.stderr)
    t0 = time.perf_counter()
    gen = SyntheticSessionGenerator(asin_num=cfg.asin_num, seed=cfg.seed)
    data = gen.dataset(n_sessions)
    print(f"# generated in {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    tok = get_tokenizer(cfg.vocab_size)
    loader = SessionGraphLoader(data, tok, cfg.dims, cfg.batch_size,
                                ignore_query=cfg.ignore_query, seed=cfg.seed)

    if args.phase == "pretrain":
        from sessionsimilaritysearch_tpu_torch.training.pretrain import (
            create_pretrain_state,
            make_train_step,
        )

        def make_state():
            return create_pretrain_state(cfg, dev)

        def make_step(model):
            return make_train_step(model, has_view=False)
    else:
        from sessionsimilaritysearch_tpu_torch.training.session_trainers import (
            create_session_state,
            make_session_train_step,
        )

        def make_state():
            return create_session_state(cfg, dev, mode="subsession")

        make_step = make_session_train_step

    t0 = time.perf_counter()
    model, state = make_state()
    raw_step = make_step(model)
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    print(f"# init {init_s:.1f}s, {n_params / 1e6:.1f}M params", file=sys.stderr)

    step_times: list = []
    losses: list = []

    def timed_step(state, batch):
        t0 = time.perf_counter()
        state, m = raw_step(state, batch)
        losses.append(float(m["loss"]))  # waits for the step
        step_times.append(time.perf_counter() - t0)
        return state, m

    rundir = RunDir(savedir, cfg, args.phase)
    ckpt = CheckpointManager(os.path.join(savedir, "ckpt"))

    t0 = time.perf_counter()
    state, _ = run_training(state=state, step_fn=timed_step, train_loader=loader, epochs=1,
                            rundir=rundir, ckpt=ckpt, log_every=10)
    train_s = time.perf_counter() - t0
    final_step = int(state.step)
    loader.close()

    st = np.asarray(step_times[1:] if len(step_times) > 1 else step_times)
    summary = {
        "phase": args.phase,
        "asin_num": cfg.asin_num,
        "batch_size": cfg.batch_size,
        "params_m": round(n_params / 1e6, 1),
        "steps": final_step,
        "first_step_s": round(step_times[0], 1) if step_times else None,
        "step_ms_median": round(float(np.median(st)) * 1e3, 1),
        "step_ms_p90": round(float(np.percentile(st, 90)) * 1e3, 1),
        "sessions_per_s": round(cfg.batch_size / float(np.median(st)), 1),
        "loss_first10_mean": round(float(np.mean(losses[:10])), 4),
        "loss_last10_mean": round(float(np.mean(losses[-10:])), 4),
        "train_wall_s": round(train_s, 1),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }

    # --- checkpoint + resume proof: a fresh state re-enters the loop, which
    # restores 'latest' and continues; the step counter must carry over
    resume_data = gen.dataset(args.resume_steps * cfg.batch_size)
    resume_loader = SessionGraphLoader(resume_data, tok, cfg.dims, cfg.batch_size,
                                       ignore_query=cfg.ignore_query, seed=cfg.seed + 1)
    del model, state, raw_step
    model, fresh = make_state()
    raw_step = make_step(model)
    if int(fresh.step) != 0:
        raise RuntimeError(f"a fresh state starts at step {int(fresh.step)}")
    resumed, _ = run_training(state=fresh, step_fn=timed_step, train_loader=resume_loader,
                              epochs=1, rundir=rundir, ckpt=ckpt)
    resume_loader.close()
    if int(resumed.step) != final_step + args.resume_steps:
        raise RuntimeError(f"the resumed run reached step {int(resumed.step)}, not "
                           f"{final_step} + {args.resume_steps}")
    summary["resume_check"] = f"restored step {final_step}, continued to {int(resumed.step)}"
    summary["loss_resumed10_mean"] = round(
        float(np.mean(losses[final_step:final_step + 10])), 4)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
