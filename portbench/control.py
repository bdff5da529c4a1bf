"""The control of ``correct``: the plain reference put in the program's
place and computed one precision below the configuration's bfloat16, in
float8 e4m3 (encoder weights and matrix-product operands, the query
embeddings and the corpus rows, each rounded under its own scale), then
checked by the same numbers and limits as a run. It has to come out not
correct.

    python -m portbench.control --workload <name> --seeds <n> [<n> ...]

prints, per seed, the control's numbers beside the limits. The answers
are those of the sessions a run checks: the kept rows of the mix's first
requests after its warm-up, a seed-drawn sample of ``judged_sessions``.
``--arith f32`` answers in the reference's own arithmetic instead (a check
of the harness: it reads nought but rounding).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from portbench import judge
from portbench.inputs import Corpus, make_catalog, make_weights, sub_seed
from portbench.reference.encoder import Arith, embed_sessions
from portbench.reference.search import scan
from portbench.run import ROOT, load_cell, log, make_mix, scan_args


def judged_sessions(traffic, tr: dict, seed: int):
    """Pool ids of the sessions a run would check, had its window answered
    the mix's first requests."""
    first = int(tr.get("warmup_requests", 1))
    kept, r = [], first
    while sum(len(x) for x in kept) < int(tr["judged_sessions"]):
        kept.append(traffic.session_ids(r)[traffic.keep_rows(r)])
        r += 1
    ids = np.concatenate(kept)
    rng = np.random.default_rng(sub_seed(seed, 5))
    return ids[np.sort(rng.choice(len(ids), min(len(ids), int(tr["judged_sessions"])),
                                  replace=False))]


def control_numbers(c, seed: int, device, arith: str = "fp8") -> dict:
    cfg, tr = c.cfg, c.traffic
    dev = torch.device(device)
    weights = make_weights(cfg["model"], seed, dev)
    catalog = make_catalog(cfg["model"], seed)
    traffic = make_mix(c, seed, catalog)
    corpus = Corpus(cfg["corpus"], 2 * cfg["model"]["gnn_nout"], seed, dev)
    sessions = [traffic.pool[i] for i in judged_sessions(traffic, tr, seed)]
    k = int(tr["k"])
    q_ctl = embed_sessions(sessions, weights, cfg["model"], Arith(arith), dev)
    ans = scan(q_ctl, corpus.blocks(), **scan_args(cfg, k, arith=arith))
    D, I = ans["scores"].cpu().numpy(), ans["ids"].cpu().numpy()
    q_ref = embed_sessions(sessions, weights, cfg["model"], Arith("f32"), dev)
    ref = scan(q_ref, corpus.blocks(), **scan_args(cfg, k, probe=torch.from_numpy(I)))
    return judge.numbers(D, I, {k_: v.cpu().numpy() for k_, v in ref.items()}, corpus.rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--arith", default="fp8", choices=("fp8", "f32"))
    args = ap.parse_args(argv)
    c = load_cell(ROOT, args.workload)
    dev = "cuda:0" if torch.cuda.is_available() else "cpu"
    limits = c.cfg["judge"]["limits"]
    for seed in args.seeds:
        t = time.monotonic()
        nums = control_numbers(c, seed, dev, args.arith)
        out = {"workload": args.workload, "seed": seed, "arith": args.arith,
               "correct": judge.verdict(nums, limits),
               "checks": judge.report(nums, limits), "seconds": time.monotonic() - t}
        print(json.dumps(out), flush=True)
        log(f"{args.workload} seed {seed} {args.arith}: {nums}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
