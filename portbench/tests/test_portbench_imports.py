"""Nothing the benchmark runs imports JAX or the JAX package, the
reference imports nothing of the program, and a cell, a traffic mix and a
metric added as files are found by name."""

import ast
import json
import shutil
from pathlib import Path

import pytest

from portbench import run
from portbench.tests.tiny import PKG, TINY_TRAFFIC, make_root

FORBIDDEN = {"jax", "jaxlib", "flax", "sessionsimilaritysearch_tpu"}
PROGRAM = "sessionsimilaritysearch_tpu_torch"


def _imported_tops(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                tops.add(str(node.args[0].value).split(".")[0])
    return tops


def _modules():
    return sorted(p for p in PKG.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", _modules(), ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_anywhere_and_no_program_in_the_reference(path):
    tops = _imported_tops(path)
    assert not tops & FORBIDDEN, f"{path} imports {tops & FORBIDDEN}"
    if "reference" in path.relative_to(PKG).parts:
        assert PROGRAM not in tops, f"{path} imports the program"


def test_the_check_compares_whole_top_level_names():
    assert _imported_tops(PKG / "program.py") & FORBIDDEN == set()
    assert PROGRAM in _imported_tops(PKG / "program.py")
    assert "sessionsimilaritysearch_tpu_torch".split(".")[0] not in FORBIDDEN


def test_reference_imports_only_itself_and_plain_libraries():
    for path in (PKG / "reference").rglob("*.py"):
        tops = _imported_tops(path)
        assert tops <= {"__future__", "math", "re", "contextlib", "typing", "numpy",
                        "torch", "portbench"}, (path, tops)
        if "portbench" in tops:
            text = path.read_text()
            for line in text.splitlines():
                if line.startswith("from portbench") or line.lstrip().startswith("from portbench"):
                    assert "portbench.reference" in line, (path, line)


def test_new_cell_traffic_and_metric_are_found_by_name(tmp_path):
    root = tmp_path
    shutil.copytree(PKG, root / PKG.name, ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((PKG.parent / "BENCHMARK.json").read_text())
    (root / PKG.name / "traffic" / "bulk-256.json").write_text(json.dumps(
        dict(json.loads((PKG / "traffic" / "bulk-1024.json").read_text()),
             request_sessions=256)))
    cfg = json.loads((PKG / "configs" / "flagship-dense-bf16.json").read_text())
    cfg["corpus"]["rows"] = 1 << 20
    (root / PKG.name / "configs" / "flagship-dense-bf16-1m.json").write_text(json.dumps(cfg))
    (root / PKG.name / "metrics" / "sessions_per_request.py").write_text(
        "def read(run):\n    return run.window.attempted / len(run.window.sessions)\n")
    bench["configs"].append({"name": "flagship-dense-bf16-1m", "source": "x",
                             "file": "portbench/configs/flagship-dense-bf16-1m.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "dense-bulk-256", "config": "flagship-dense-bf16-1m",
                               "traffic": "bulk-256", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "sessions_per_request", "unit": "sessions",
                               "better": "higher", "source": "program_counter",
                               "layer": "engine", "moves": "qps",
                               "workloads": ["dense-bulk-256"]})
    bench["end_to_end"][0]["workloads"].append("dense-bulk-256")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = run.load_cell(root, "dense-bulk-256")
    assert c.cfg["corpus"]["rows"] == 1 << 20
    assert c.traffic["request_sessions"] == 256
    assert [m["name"] for m in c.end_to_end] == ["qps", "setup_s"]
    assert "sessions_per_request" in [m["name"] for m in c.per_layer]

    class W:
        attempted, sessions = 512, [256, 256]

    class R:
        window = W

    assert run.metric_reader(root, "sessions_per_request")(R) == 256.0
    # the cells already there are found as before
    assert [m["name"] for m in run.load_cell(root, "twostage-bulk-1024").end_to_end] == \
        ["qps", "setup_s"]


SPLIT_DRIVER = """
from portbench.traffic import closed


class Mix(closed.Mix):
    def serve(self, engine, sessions, spans):
        return engine.search_embeddings(engine.embed(sessions, out="device"), self.k)
"""


def test_a_mix_with_a_driver_of_its_own_runs_by_name(tmp_path):
    """A mix whose driver, a new file, sends its requests through other
    verbs of the engine runs a whole cell with no edit."""
    root = make_root(tmp_path)
    (root / PKG.name / "traffic" / "split.py").write_text(SPLIT_DRIVER)
    (root / PKG.name / "traffic" / "tiny-split.json").write_text(json.dumps(
        dict(TINY_TRAFFIC, driver="split")))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny-split", "config": "tiny-dense",
                               "traffic": "tiny-split", "chips": 1, "why": "x"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    def no_search(eng):
        def refuse(*a, **kw):
            raise AssertionError("the split driver does not call search")

        eng.search = refuse

    r = run.run_cell(run.load_cell(root, "tiny-split"), 2**33 + 1, 0.5, False, "cpu",
                     breaker=no_search)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0, r
