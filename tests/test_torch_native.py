"""The port's native host library (locityper_tpu_torch/native/): built once
when several processes load it at the same moment, never loaded half
written, loaded wherever a toolchain exists, and a failed build is logged.

Each test that builds works on a copy of the package's native/ directory
(Makefile, kernels.cpp, __init__.py) in a temporary directory, loaded by
path, so the package's own library is left as it is.
"""
import ctypes
import importlib.util
import logging
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from locityper_tpu_torch import native

NATIVE_DIR = Path(native.__file__).parent
TOOLCHAIN = all(shutil.which(tool) for tool in ("make", "g++"))
needs_toolchain = pytest.mark.skipif(not TOOLCHAIN, reason="no make or g++")

LOAD = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("native_copy", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
print("loaded" if mod.get_lib() is not None else "fallback")
"""


def native_copy(tmp_path) -> Path:
    """A fresh copy of the package's native/ directory, with no library."""
    dest = tmp_path / "native"
    dest.mkdir()
    for name in ("Makefile", "kernels.cpp", "__init__.py"):
        shutil.copy(NATIVE_DIR / name, dest / name)
    return dest


def load_by_path(init: Path):
    spec = importlib.util.spec_from_file_location(
        f"native_copy_{abs(hash(init))}", init)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@needs_toolchain
def test_processes_started_together_each_load_the_library(tmp_path):
    """Six processes, started 0.3 s apart against a directory with no
    library, all load one: the first builds it under the lock and the rest
    wait for it, then find it up to date."""
    d = native_copy(tmp_path)
    procs = []
    for _ in range(6):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", LOAD, str(d / "__init__.py")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        time.sleep(0.3)
    outs = [p.communicate(timeout=600) for p in procs]
    assert [p.returncode for p in procs] == [0] * 6, [e for _, e in outs]
    assert [o.strip() for o, _ in outs] == ["loaded"] * 6
    ctypes.CDLL(str(d / "libkernels.so"))
    assert not (d / "libkernels.so.tmp").exists()


@needs_toolchain
def test_the_package_library_loads_where_a_toolchain_exists():
    """No silent numpy fallback: where `make` and `g++` exist, the port's
    native parser and k-mer kernels are the ones the tests run."""
    assert native.get_lib() is not None and native.available()


@needs_toolchain
def test_a_failed_build_is_logged_once_and_falls_back(tmp_path, caplog):
    d = native_copy(tmp_path)
    (d / "kernels.cpp").write_text("this is not C++\n")
    mod = load_by_path(d / "__init__.py")
    with caplog.at_level(logging.WARNING, logger="locityper.native"):
        assert mod.get_lib() is None
        assert mod.get_lib() is None and not mod.available()
    warned = [r for r in caplog.records if r.name == "locityper.native"]
    assert len(warned) == 1 and "failed" in warned[0].getMessage()
    assert not (d / "libkernels.so").exists()
