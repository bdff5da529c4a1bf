"""A copy of the benchmark at a size a CPU test holds: the tiny widths,
a corpus of 8,192 rows and requests of 32 sessions, in a temporary root
with its own ``BENCHMARK.json``."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent

TINY_MODEL = {
    "emb_len": 16, "code_len": 32, "max_seq_len": 20, "ignore_query": True,
    "query_embedder_nhead": 2, "query_embedder_nhid": 32, "query_embedder_nlayers": 1,
    "gnn_nhid": 32, "gnn_nout": 32, "gnn_nhead": 4, "gnn_nlayers": 2,
    "gnn_pooling_out": 16, "product_pooling": "srgnn", "text_encoder_dim": 32,
    "token_len": 20, "vocab_size": 1000, "asin_num": 1000, "retrieval_k": 10,
}
TINY_TRAFFIC = {"driver": "closed", "request_sessions": 32, "k": 10,
                "session_len": [1, 20], "distinct_sessions": 128, "warmup_requests": 1,
                "kept_per_request": 8, "judged_sessions": 64}


def tiny_config(semantics: str) -> dict:
    name = "flagship-dense-bf16" if semantics == "exact" else "flagship-simhash256-twostage"
    cfg = json.loads((PKG / "configs" / f"{name}.json").read_text())
    cfg["model"] = dict(TINY_MODEL)
    cfg["corpus"] = {"rows": 8192, "centers": 64, "noise": 1.0, "block_rows": 2048}
    cfg["engine"]["batch_size"] = 32
    return cfg


def make_root(tmp: Path, limits: dict = None) -> Path:
    """A root holding a copy of ``portbench/`` and a ``BENCHMARK.json``
    with the cells ``tiny-dense`` and ``tiny-twostage``."""
    root = Path(tmp)
    shutil.copytree(PKG, root / PKG.name, ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((PKG.parent / "BENCHMARK.json").read_text())
    cells = []
    for sem, cell in (("exact", "tiny-dense"), ("twostage", "tiny-twostage")):
        cfg = tiny_config(sem)
        if limits is not None:
            cfg["judge"]["limits"].update(limits)
        path = f"{PKG.name}/configs/{cell}.json"
        (root / path).write_text(json.dumps(cfg))
        cells.append({"name": cell, "config": cell, "traffic": "tiny", "chips": 1,
                      "why": "a CPU test"})
        bench["configs"].append({"name": cell, "source": "test", "file": path,
                                 "reduced": [], "why": "a CPU test"})
    (root / PKG.name / "traffic" / "tiny.json").write_text(json.dumps(TINY_TRAFFIC))
    bench["workloads"] = cells
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
