"""Flagship-scale training campaign (counterpart of
``examples/flagship_campaign.py``).

A multi-epoch pretrain over a synthetic corpus at the reference's widths
(gnn 800 / text 768 -> 1600-d session embedding, asin_num=391,572), with
what a training owner watches: steps/s and sessions/s over the run, the
step's FLOPs and achieved FLOP/s, the loss curve (sampled every
``--log-every`` steps and kept across process restarts), and a crash /
resume drill: ``--crash-at-step N`` ends the process with ``os._exit(3)``
mid-epoch; the same command run again restores the last step-granular
checkpoint, fast-forwards the same shuffled batch order to the exact batch
and continues. Steps between the checkpoint and the crash run twice, and
their losses must agree (``replay_loss_max_dev``).

    python -m sessionsimilaritysearch_tpu_torch.examples.flagship_campaign \\
        --sessions 1000000 --epochs 3 --out campaign.json
    python -m sessionsimilaritysearch_tpu_torch.examples.flagship_campaign ... --crash-at-step 6000
    python -m sessionsimilaritysearch_tpu_torch.examples.flagship_campaign ...   # resumes
    python -m sessionsimilaritysearch_tpu_torch.examples.flagship_campaign --device cpu --tiny

The event log ``<savedir>/campaign_log.jsonl`` and the checkpoints
``<savedir>/ckpt/latest.pt`` and ``campaign_meta.pt`` (epoch, batch index,
global step) are written after every ``--ckpt-every`` steps and at each
epoch's end. Each epoch's loader is seeded with ``seed * 1009 + epoch``.

Differences from the JAX script:

- ``--platform`` is ``--device {cuda,cpu}``, default ``cuda``, resolved
  first (``device.resolve_device``): without a card the run raises unless
  ``--device cpu`` is given.
- The step's random draws come from the train state's generator, reseeded
  before every step from ``(seed + 17, global_step)`` alone
  (:func:`step_seed`), as JAX folds the global step into a base key: a
  replayed step draws what it drew before, whatever ran earlier.
- No share of a TPU peak: ``flops_per_step_g`` is counted once with
  ``torch.utils.flop_counter.FlopCounterMode`` over one whole step (forward,
  backward, optimizer), and ``achieved_tflops`` divides it by the median
  step of the timed window. ``compile_s`` becomes ``first_step_s`` (the
  first step of this process, run under the counter); ``platform`` becomes
  ``device`` (the card's name, or ``cpu``). ``mfu_vs_v5e_bf16_peak`` is
  gone.
- The loss log keeps each loss unrounded; it also records each save's
  seconds (``checkpoint`` events) and the restore's (``restore_s`` of the
  ``start`` event).
- ``--cached-text`` passes the title and keyword tables to the step
  (``tables=``); the batch's token grids are uploaded as they are (JAX
  replaces them with zeros on the device to save its upload).
- A resume refuses a ``latest`` / ``campaign_meta`` pair whose steps differ
  (a crash between the two saves) with a ``RuntimeError``.
- ``--savedir`` defaults to ``flagship_campaign`` in the temporary
  directory (``tempfile.gettempdir()``).
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


def _append_event(path: str, ev: dict) -> None:
    with open(path, "a") as f:
        f.write(json.dumps(ev) + "\n")


def _read_events(path: str) -> list:
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def step_seed(seed: int, global_step: int) -> int:
    """The generator seed of the step after ``global_step`` steps: a
    function of ``(seed + 17, global_step)`` alone."""
    return ((seed + 17) << 32) + global_step


def make_loader(data, tok, cfg, seed: int, epoch: int):
    """Epoch ``epoch``'s loader: a fresh but reproducible shuffle (seed
    ``seed * 1009 + epoch``), so a resume rebuilds the same order and
    fast-forwards it."""
    from sessionsimilaritysearch_tpu_torch.data.loader import SessionGraphLoader

    return SessionGraphLoader(
        data, tok, cfg.dims, cfg.batch_size, shuffle=True,
        ignore_query=cfg.ignore_query, drop_last=True, cache=False,
        seed=seed * 1009 + epoch, prefetch=2,
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=1_000_000)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--asin-num", type=int, default=391_572)
    ap.add_argument("--ckpt-every", type=int, default=500, help="checkpoint cadence in steps")
    ap.add_argument("--log-every", type=int, default=50,
                    help="loss materialization/sampling cadence in steps")
    ap.add_argument("--timed-window", type=int, default=40,
                    help="steps timed with per-step sync for latency stats")
    ap.add_argument("--crash-at-step", type=int, default=-1,
                    help="hard-exit (os._exit 3) at this global step")
    ap.add_argument("--cached-text", action="store_true",
                    help="serve the frozen text backbone from precomputed title/keyword "
                         "tables (training.pretrain tables=)")
    ap.add_argument("--savedir", default=os.path.join(tempfile.gettempdir(),
                                                      "flagship_campaign"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)

    from sessionsimilaritysearch_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)

    from torch.utils.flop_counter import FlopCounterMode

    from sessionsimilaritysearch_tpu_torch.config import Config, tiny_test_config
    from sessionsimilaritysearch_tpu_torch.data.synthetic import SyntheticSessionGenerator
    from sessionsimilaritysearch_tpu_torch.evalharness.harness import to_device
    from sessionsimilaritysearch_tpu_torch.tokenizer import get_tokenizer
    from sessionsimilaritysearch_tpu_torch.training.pretrain import (
        create_pretrain_state,
        make_train_step,
    )
    from sessionsimilaritysearch_tpu_torch.utils.checkpoint import (
        CheckpointManager,
        state_to_tree,
        tree_to_state,
    )

    if args.tiny:
        cfg = tiny_test_config().replace(batch_size=32, seed=args.seed)
        args.sessions = min(args.sessions, 1024)
        args.epochs = min(args.epochs, 2)
        args.ckpt_every = min(args.ckpt_every, 4)
        args.log_every = min(args.log_every, 2)
        args.timed_window = min(args.timed_window, 5)
    else:
        cfg = Config().replace(asin_num=args.asin_num, batch_size=args.batch_size,
                               seed=args.seed)

    os.makedirs(args.savedir, exist_ok=True)
    log_path = os.path.join(args.savedir, "campaign_log.jsonl")
    ckpt = CheckpointManager(os.path.join(args.savedir, "ckpt"))

    # --- data: generated once per invocation, deterministically, so a
    # resumed process trains on identical data
    t0 = time.perf_counter()
    gen = SyntheticSessionGenerator(asin_num=cfg.asin_num, seed=cfg.seed)
    data = gen.dataset(args.sessions)
    gen_s = time.perf_counter() - t0
    steps_per_epoch = len(data) // cfg.batch_size  # drop_last
    total_steps = steps_per_epoch * args.epochs
    print(f"# {len(data)} sessions generated in {gen_s:.1f}s; "
          f"{steps_per_epoch} steps/epoch x {args.epochs} epochs "
          f"= {total_steps} steps", file=sys.stderr)

    tok = get_tokenizer(cfg.vocab_size)
    model, state = create_pretrain_state(cfg, dev)
    n_params = sum(p.numel() for p in model.parameters())
    step = make_train_step(model, has_view=False)

    # --- cached-text mode: the frozen text backbone's forward is a constant
    # function of the token rows, so the title and keyword catalogs are
    # embedded once (the same seed gives the same weights on every restart)
    # and the step gathers from them
    make_tables = None
    if args.cached_text:
        from sessionsimilaritysearch_tpu_torch.evalharness.harness import (
            build_keyword_table,
            build_title_table,
            keyword_ids,
        )

        t0 = time.perf_counter()
        title_table = build_title_table(cfg, tok, gen.titles, model.encoder, batch_size=2048)
        kws = sorted({a[2] or "" for pair in data for seq in pair for a in seq
                      if a[1] == "s"})
        qtable, kw_lookup = build_keyword_table(cfg, tok, kws, model.encoder,
                                                batch_size=2048)
        print(f"# cached-text tables: {title_table.shape[0]} titles + "
              f"{qtable.shape[0]} keywords in {time.perf_counter() - t0:.1f}s",
              file=sys.stderr)

        def make_tables(host_batch):
            kw = keyword_ids(kw_lookup, np.asarray(host_batch.query_input_ids))
            if kw is None:
                raise RuntimeError("a keyword outside the prebuilt table")
            return {"title_table": title_table, "query_table": qtable,
                    "query_kw": torch.from_numpy(kw).to(dev)}

    # --- resume position
    start_epoch, start_batch, global_step = 0, 0, 0
    resumed_from = None
    restore_s = None
    if ckpt.has("latest") and ckpt.has("campaign_meta"):
        t0 = time.perf_counter()
        tree = ckpt.restore("latest", map_location=dev)
        meta = ckpt.restore("campaign_meta")
        if int(meta["global_step"]) != int(tree["step"]):
            raise RuntimeError(
                f"checkpoint 'latest' holds step {int(tree['step'])} but 'campaign_meta' "
                f"step {int(meta['global_step'])}: the run stopped between the two saves")
        tree_to_state(state, tree)
        del tree
        restore_s = time.perf_counter() - t0
        start_epoch = int(meta["epoch"])
        start_batch = int(meta["batch_idx"])
        global_step = int(meta["global_step"])
        resumed_from = {"epoch": start_epoch, "batch_idx": start_batch,
                        "global_step": global_step}
        print(f"# resumed at step {global_step} "
              f"(epoch {start_epoch}, batch {start_batch})", file=sys.stderr)
    _append_event(log_path, {
        "event": "start", "resumed_from": resumed_from, "restore_s": restore_s,
        "crash_at_step": args.crash_at_step, "t": time.time(),
    })

    step_times: list = []
    pending = None  # (step, metrics) not yet read on the host
    flops_per_step = first_step_s = None
    train_t0 = time.perf_counter()
    trained_this_run = 0

    def save(epoch: int, batch_idx: int) -> None:
        t0 = time.perf_counter()
        ckpt.save("latest", state_to_tree(state))
        ckpt.save("campaign_meta", {"epoch": epoch, "batch_idx": batch_idx,
                                    "global_step": global_step})
        _append_event(log_path, {"event": "checkpoint", "step": global_step,
                                 "s": time.perf_counter() - t0})

    for epoch in range(start_epoch, args.epochs):
        loader = make_loader(data, tok, cfg, args.seed, epoch)
        skip = start_batch if epoch == start_epoch else 0
        ff_t0 = time.perf_counter()
        it = iter(loader)
        for _ in range(skip):  # fast-forward the shuffled order
            next(it)
        if skip:
            _append_event(log_path, {
                "event": "fast_forward", "epoch": epoch, "batches": skip,
                "s": round(time.perf_counter() - ff_t0, 1)})
        batch_idx = skip
        for batch in it:
            state.generator.manual_seed(step_seed(args.seed, global_step))
            timed = len(step_times) < args.timed_window and skip == 0
            t0 = time.perf_counter()
            extra = {} if make_tables is None else {"tables": make_tables(batch)}
            first = flops_per_step is None
            if first:
                # the first step of this process: count its FLOPs, time it
                # apart from the window, and log its loss
                with FlopCounterMode(display=False) as counter:
                    state, m = step(state, to_device(batch, dev), **extra)
                    loss = float(m["loss"])
                flops_per_step = counter.get_total_flops()
                first_step_s = time.perf_counter() - t0
                timed, pending = False, None
            else:
                state, m = step(state, to_device(batch, dev), **extra)
                if timed:
                    loss = float(m["loss"])  # waits for the step
                    step_times.append(time.perf_counter() - t0)
                    pending = None
                else:
                    pending = (global_step + 1, m)
            global_step += 1
            batch_idx += 1
            trained_this_run += 1
            if global_step % args.log_every == 0 or timed or first:
                if pending is not None:
                    loss = float(pending[1]["loss"])
                    pending = None
                if not np.isfinite(loss):
                    raise FloatingPointError(f"loss={loss} @ {global_step}")
                _append_event(log_path, {
                    "event": "loss", "step": global_step, "epoch": epoch, "loss": loss})
            if global_step % args.ckpt_every == 0:
                save(epoch, batch_idx)
            if args.crash_at_step == global_step:
                print(f"# CRASH DRILL: os._exit(3) at step {global_step}", file=sys.stderr)
                sys.stderr.flush()
                os._exit(3)
        loader.close()
        start_batch = 0
        save(epoch + 1, 0)
        _append_event(log_path, {
            "event": "epoch_done", "epoch": epoch, "step": global_step,
            "wall_s": round(time.perf_counter() - train_t0, 1)})

    train_s = time.perf_counter() - train_t0

    # --- summary over the whole campaign (all invocations), from the log
    events = _read_events(log_path)
    raw_losses = sorted((e["step"], e["loss"]) for e in events if e["event"] == "loss")
    # steps between the last checkpoint and a crash are replayed on resume
    # (the restored state, the same per-step seed, the same batch order), so
    # a duplicated step's loss must reproduce
    by_step: dict = {}
    replay_max_dev = 0.0
    for s_, v in raw_losses:
        if s_ in by_step:
            replay_max_dev = max(replay_max_dev, abs(v - by_step[s_]))
        by_step[s_] = v
    losses = sorted(by_step.items())
    first10 = [v for _, v in losses[:10]]
    last10 = [v for _, v in losses[-10:]]
    st = np.asarray(step_times[1:] if len(step_times) > 1 else step_times)
    step_ms = float(np.median(st)) * 1e3 if st.size else None
    sustained_sps = trained_this_run / train_s if train_s > 0 else None
    achieved_tflops = None
    if flops_per_step and step_ms:
        achieved_tflops = flops_per_step / (step_ms / 1e3) / 1e12
    crash_events = [e for e in events if e["event"] == "start" and e["resumed_from"]]
    summary = {
        "sessions": len(data), "epochs": args.epochs,
        "batch_size": cfg.batch_size, "asin_num": cfg.asin_num,
        "params_m": round(n_params / 1e6, 1),
        "steps_total": global_step,
        "steps_per_epoch": steps_per_epoch,
        "gen_s": round(gen_s, 1),
        "first_step_s": round(first_step_s, 2) if first_step_s is not None else None,
        "flops_per_step_g": round(flops_per_step / 1e9, 1) if flops_per_step else None,
        "step_ms_median_timed_window": round(step_ms, 1) if step_ms else None,
        "step_ms_p90_timed_window": (round(float(np.percentile(st, 90)) * 1e3, 1)
                                     if st.size else None),
        "achieved_tflops": round(achieved_tflops, 1) if achieved_tflops else None,
        "sustained_steps_per_s": (round(trained_this_run / train_s, 2)
                                  if train_s > 0 and trained_this_run else None),
        "sustained_sessions_per_s_this_run": (round(sustained_sps * cfg.batch_size, 1)
                                              if sustained_sps else None),
        "train_wall_s_this_run": round(train_s, 1),
        "loss_first10_mean": round(float(np.mean(first10)), 4) if first10 else None,
        "loss_last10_mean": round(float(np.mean(last10)), 4) if last10 else None,
        "loss_curve": losses[:: max(1, len(losses) // 200)],
        "resume_seams": [e["resumed_from"] for e in crash_events],
        "replay_loss_max_dev": round(replay_max_dev, 6),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    _append_event(log_path, {"event": "done", **summary})
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps({k: v for k, v in summary.items() if k != "loss_curve"}))
    return summary


if __name__ == "__main__":
    main()
