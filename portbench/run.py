"""Run one cell of ``BENCHMARK.json`` and print its result line.

    python -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell names its configuration (``configs/<config>.json``: widths,
engine, corpus, host threads, semantics, scoring kernels, the check's
limits) and its traffic (``traffic/<mix>.json``, whose ``driver`` names the
module ``traffic/<driver>.py`` that sends it). Set-up makes the weights, the
catalog, the query sessions and the corpus from the seed, builds the
program's engine, fills its index and has the driver send the mix's
warm-up requests. The driver then runs the traffic for ``--seconds``; with
``--trace 1`` under ``torch.profiler`` for the window's first
``PROFILED_SECONDS``, each stretch of a request that the driver names in a
span of its own. Afterwards the program is freed and the plain reference
checks a sample of the window's answers (``judge.py``). The last line of
standard output is the result; the numbers compared, each beside its limit,
are the last lines of standard error and the result's last key. Each
metric is read by ``metrics/<name>.py``.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Callable, Optional  # noqa: E402

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
# the caches that a run fills stay inside the checkout, at fixed paths
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / ".portbench_cache" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / ".portbench_cache" / "torch_extensions"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import judge, roofline  # noqa: E402
from portbench.inputs import Corpus, make_catalog, make_weights, sub_seed  # noqa: E402
from portbench.reference.encoder import Arith, embed_sessions  # noqa: E402
from portbench.reference.graph import node_counts  # noqa: E402
from portbench.reference.search import scan  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "sessionsimilaritysearch_tpu")
MAX_REQUESTS = 200_000
# a traced run profiles the first seconds of its window only: the dense
# cell launches ~2,000 operations a request, and a profile of the whole
# window takes minutes to export and read
PROFILED_SECONDS = 10.0


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def load_cell(root: Path, name: str) -> SimpleNamespace:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its configuration,
    traffic and the metrics it reports, each found by name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((root / PKG.name / "traffic" / f"{cell['traffic']}.json").read_text())

    def mine(ms):
        return [m for m in ms if name in m.get("workloads", [name])]

    return SimpleNamespace(name=name, root=root, cell=cell, cfg=cfg, traffic=traffic,
                           end_to_end=mine(bench["end_to_end"]),
                           per_layer=mine(bench["per_layer"]))


def _load(root: Path, kind: str, name: str):
    path = root / PKG.name / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(root: Path, name: str) -> Callable:
    return _load(root, "metrics", name).read


def make_mix(c: SimpleNamespace, seed: int, catalog):
    """The requests of cell ``c``'s mix, made by its driver module."""
    driver = _load(c.root, "traffic", c.traffic["driver"])
    return driver.Mix(c.traffic, seed, catalog, MAX_REQUESTS)


def set_host_threads(cfg: dict) -> None:
    """The deployment's host threads: torch's pool and the OpenMP teams of
    the libraries loaded after this (the program's graph builder)."""
    n = int(cfg["host"]["threads"])
    os.environ["OMP_NUM_THREADS"] = str(n)
    torch.set_num_threads(n)


class Spans:
    """The spans a driver marks in its requests: under the profiler each is
    a ``portbench.<name>`` range closed by a synchronize, and its host
    seconds are kept per name. Untraced, nothing is marked."""

    def __init__(self, device, traced: bool):
        self.device, self.traced = device, traced
        self.host = {}
        self.prof, self._since = None, None

    @contextlib.contextmanager
    def __call__(self, name: str):
        with torch.profiler.record_function(f"portbench.{name}"):
            t = time.perf_counter()
            yield
            _sync(self.device)
        self.host.setdefault(name, []).append(time.perf_counter() - t)

    def start(self) -> None:
        """Profiles from here to the first request boundary
        ``PROFILED_SECONDS`` later; its host seconds start afresh."""
        self.host = {}
        if not self.traced:
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self._since = time.perf_counter()

    def between(self) -> None:
        if self._since is not None and time.perf_counter() - self._since >= PROFILED_SECONDS:
            self.stop()

    def stop(self) -> None:
        if self._since is not None:
            self._since = None
            self.prof.__exit__(None, None, None)


def card_info() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,"
             "clocks.mem,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def _collections() -> int:
    return sum(g["collections"] for g in gc.get_stats())


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def request_work(cfg: dict, sessions: list, flops: dict) -> dict:
    """{part: (ops, bytes, peak)} of one request: the encoder at each
    session's own node counts (``flops`` caches a count per shape), the
    scan and the re-rank at the request's size."""
    m, c = cfg["model"], cfg["corpus"]
    d, q = 2 * m["gnn_nout"], len(sessions)
    enc = 0.0
    for s in sessions:
        nodes = node_counts(s, m["max_seq_len"], m["ignore_query"])
        if nodes not in flops:
            flops[nodes] = roofline.encoder_flops(m, 1, nodes)
        enc += flops[nodes]
    work = {"encoder": (enc, 0.0, "bf16")}
    if cfg["semantics"] == "exact":
        work["scan"] = roofline.dense_scan(q, c["rows"], d)
    else:
        work["scan"] = roofline.binary_scan(q, c["rows"], cfg["engine"]["n_bits"])
        work["rerank"] = roofline.rerank(q, cfg["engine"]["pool"], d)
    return work


def check(cfg: dict, tr: dict, window, weights, pool, corpus, device, seed: int) -> dict:
    """The compared numbers of a seed-drawn sample of the window's kept
    answers, against the reference."""
    ids = np.concatenate(window.kept_ids)
    D = np.concatenate(window.kept_D)
    I = np.concatenate(window.kept_I)
    rng = np.random.default_rng(sub_seed(seed, 5))
    pick = np.sort(rng.choice(len(ids), min(len(ids), int(tr["judged_sessions"])),
                              replace=False))
    sessions = [pool[i] for i in ids[pick]]
    q = embed_sessions(sessions, weights, cfg["model"], Arith("f32"), device)
    ref = scan(q, corpus.blocks(), **scan_args(cfg, int(tr["k"]), torch.from_numpy(I[pick])))
    ref = {k: v.cpu().numpy() for k, v in ref.items()}
    return judge.numbers(D[pick], I[pick], ref, corpus.rows)


def scan_args(cfg: dict, k: int, probe=None, arith: str = "f32") -> dict:
    """The reference scan of the configuration's semantics: for the
    two-stage, the SimHash projection drawn again as the index draws it."""
    eng = cfg["engine"]
    kw = dict(semantics=cfg["semantics"], k=k, arith=arith, probe=probe)
    if cfg["semantics"] == "twostage":
        g = torch.Generator().manual_seed(int(eng.get("projection_seed", 0)))
        kw.update(pool=int(eng["pool"]),
                  projection=torch.randn(2 * cfg["model"]["gnn_nout"], int(eng["n_bits"]),
                                         generator=g))
    return kw


def run_cell(c: SimpleNamespace, seed: int, seconds: float, trace: bool, device,
             breaker: Optional[Callable] = None, t_start: float = T_START) -> dict:
    """One run of cell ``c``; ``breaker(engine)``, when given, is called
    after the warm-up (the tests break the timed path with it)."""
    from portbench import program

    cfg, tr = c.cfg, c.traffic
    dev = torch.device(device)
    t = time.monotonic()
    weights = make_weights(cfg["model"], seed, dev)
    catalog = make_catalog(cfg["model"], seed)
    mix = make_mix(c, seed, catalog)
    keywords = sorted({a[2] for s in mix.pool for a in s if a[1] == "s"})
    corpus = Corpus(cfg["corpus"], 2 * cfg["model"]["gnn_nout"], seed, dev)
    log(f"set-up: inputs {time.monotonic() - t:.3f} s")
    t = time.monotonic()
    eng = program.build_engine(cfg, weights, catalog, keywords, corpus, dev)
    _sync(dev)
    log(f"set-up: engine, tables and {corpus.rows} rows {time.monotonic() - t:.3f} s")

    spans = Spans(dev, trace)
    t = time.monotonic()
    first = mix.warmup(eng, spans)
    _sync(dev)
    log(f"set-up: {first} warm-up requests {time.monotonic() - t:.3f} s")
    if breaker is not None:
        breaker(eng)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    counts0 = program.launch_counts()
    # what set-up made stays: no collection walks it inside the window
    gc.collect()
    gc.freeze()
    setup_s = time.monotonic() - t_start
    cpu0, gcs0 = time.process_time(), _collections()
    spans.start()
    try:
        window = mix.window(eng, seconds, spans, first)
        _sync(dev)
    finally:
        spans.stop()
        gc.unfreeze()
    cpu_s, gcs = time.process_time() - cpu0, _collections() - gcs0
    counts1 = program.launch_counts()
    launches = {k: counts1[k] - counts0[k] for k in counts0}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    retries = torch.cuda.memory_stats(dev).get("num_alloc_retries", 0) if dev.type == "cuda" else 0
    log(f"window: {len(window.sessions)} requests, {window.attempted} sessions, "
        f"{window.n_failed} failed, {window.seconds:.3f} s; launches {launches}; "
        f"host CPU {cpu_s:.3f} s, {gcs} collections, {retries} allocator retries")
    if window.latency_s:
        lat = np.asarray(window.latency_s) * 1e3
        log("window latency ms: min {:.3f} p50 {:.3f} p95 {:.3f} max {:.3f}".format(
            lat.min(), *np.percentile(lat, [50, 95]), lat.max()))
        slow = np.argsort(lat)[::-1][:5]
        log("window slowest requests (position: ms): " + ", ".join(
            f"{i}: {lat[i]:.3f}" for i in sorted(slow)))
    for e in window.errors[:5]:
        log(f"request failed: {e}")
    del eng
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    tr_obj = None
    if spans.prof is not None:
        from portbench.trace import Trace, export_events

        tr_obj = Trace(export_events(spans.prof))
        spans.prof = None
    t = time.monotonic()
    nums = check(cfg, tr, window, weights, mix.pool, corpus, dev, seed)
    log(f"check: {time.monotonic() - t:.3f} s")
    limits = cfg["judge"]["limits"]
    ok = judge.verdict(nums, limits) and window.n_failed == 0 and len(window.kept_ids) > 0

    # the requests the profile holds: the window's first ones
    profiled = window.requests[: tr_obj.count("index")] if tr_obj is not None else []
    flops = {}
    rec = SimpleNamespace(window=window, setup_s=setup_s, trace=tr_obj, host=spans.host,
                          work=[request_work(cfg, mix.sessions(r), flops) for r in profiled],
                          scoring=cfg["scoring_kernels"])
    metrics = {}
    for m in (c.per_layer if trace else c.end_to_end):
        v = metric_reader(c.root, m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {"correct": bool(ok), "attempted": window.attempted,
              "failed": window.n_failed, "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                         "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
                         else "cpu",
                         "count": int(c.cell["chips"]), "memory_peak_bytes": int(peak)}}
    if tr_obj is not None:
        result["device"]["busy_s"] = tr_obj.busy_s()
        result["device"]["window_s"] = tr_obj.window_s
        result["breakdown"] = {"device_ops": tr_obj.top_device_ops(),
                               "idle_gaps": tr_obj.idle_gaps()}
    result["checks"] = judge.report(nums, limits)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    c = load_cell(ROOT, args.workload)
    set_host_threads(c.cfg)
    chips = int(c.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(f"card: {card_info()}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    result = run_cell(c, args.seed, args.seconds, bool(args.trace), "cuda:0")
    found = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    if found:
        log(f"the run loaded {', '.join(found[:10])}: no result")
        return 3
    log(f"card after the window: {card_info()}")
    for name, v in result["checks"].items():
        log(f"check {name}: {v['value']!r} (limit {v['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
