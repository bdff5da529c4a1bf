"""The port's build of its native graph builder
(``sessionsimilaritysearch_tpu_torch/native_build.py``, sources in
``sessionsimilaritysearch_tpu_torch/native/``): built without OpenMP from a
copy of the sources, the library loads and builds the same graph batches as
the Python builder."""

import shutil

import numpy as np
import pytest

from sessionsimilaritysearch_tpu_torch import native, native_build
from sessionsimilaritysearch_tpu_torch.config import tiny_test_config
from sessionsimilaritysearch_tpu_torch.data import (
    SessionGraph,
    SyntheticSessionGenerator,
    batch_graphs,
    build_graph_batch,
    sequence_to_graph,
)
from sessionsimilaritysearch_tpu_torch.tokenizer import get_tokenizer


@pytest.fixture
def toolchain():
    if shutil.which("make") is None or shutil.which("g++") is None:
        pytest.skip("needs make and a C++ compiler (g++)")


@pytest.fixture
def serial_library(toolchain, tmp_path, monkeypatch):
    for name in native_build.SOURCES:
        shutil.copy(native_build.NATIVE_DIR / name, tmp_path / name)
    assert native_build.build_native_library(tmp_path, openmp=False)
    assert not list(tmp_path.glob("*.o"))  # built in a scratch copy
    # point the port's loader at the copy; monkeypatch restores it after
    monkeypatch.setattr(native, "_SO", str(tmp_path / native_build.LIBRARY))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    return tmp_path / native_build.LIBRARY


def test_serial_build_matches_python_builder(serial_library):
    assert native.load() is not None
    cfg = tiny_test_config()
    tok = get_tokenizer(cfg.vocab_size)
    data = SyntheticSessionGenerator(asin_num=200, seed=9).dataset(64)
    nat = build_graph_batch(data, tok, cfg.dims, ignore_query=True)
    ref = batch_graphs([sequence_to_graph(i, s, t, tok, cfg.dims, ignore_query=True)
                        for i, (s, t) in enumerate(data)])
    for name, a, b in zip(SessionGraph._fields, nat, ref):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_serial_flags_are_the_makefile_flags_without_openmp():
    makefile = (native_build.NATIVE_DIR / "Makefile").read_text()
    flags = next(ln.split("?=", 1)[1].split() for ln in makefile.splitlines()
                 if ln.startswith("CXXFLAGS"))
    assert native_build.SERIAL_CXXFLAGS.split() == [f for f in flags if f != "-fopenmp"]


def test_ensure_reports_the_present_library(toolchain):
    # builds the library into the port's own native/ directory when it is
    # missing; the JAX package's directory is never written
    kind = native_build.ensure_native_library()
    assert kind in ("present", "openmp", "serial")
    assert (native_build.NATIVE_DIR / native_build.LIBRARY).exists()
    assert native_build.NATIVE_DIR.parent.name == "sessionsimilaritysearch_tpu_torch"
