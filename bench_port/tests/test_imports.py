"""The run's look at `sys.modules`, and the yardstick's own imports."""
import ast
import subprocess
import sys
import types
from pathlib import Path

from bench_port import run

HERE = Path(run.__file__).resolve().parent


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "locityper_tpu_torch_like",
                        types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "locityper_tpu.seq",
                        types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("x"))
    assert run.forbidden_modules() == ["jax", "locityper_tpu"]


def imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_yardstick_imports_nothing_of_the_program():
    """The reference, the generator, the counters and the metric readers
    import neither the port, nor the JAX package, nor JAX."""
    files = [HERE / f for f in ("reference.py", "gen.py", "roofline.py")] \
        + sorted((HERE / "metrics").glob("*.py"))
    for f in files:
        tops = {m.split(".")[0] for m in imported(f)}
        assert not tops & {"locityper_tpu_torch", "locityper_tpu", "jax",
                           "jaxlib", "flax"}, f


def test_the_reference_loads_alone():
    code = ("import sys; import bench_port.reference, bench_port.gen; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'locityper_tpu_torch', 'locityper_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent,
                         capture_output=True, text=True, check=True).stdout
    assert out.strip() == "[]"


def test_a_run_without_a_card_prints_no_result(tmp_path):
    """No CUDA device: exit code 2, nothing on standard output; and in a
    directory holding only BENCHMARK.json and bench_port/ the same."""
    import shutil
    shutil.copy(HERE.parent / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path)}
    for cwd in (HERE.parent, tmp_path):
        p = subprocess.run(
            [sys.executable, "-m", "bench_port.run", "--workload",
             "hla_abc_sr.locus_reads", "--seed", "1", "--seconds", "1",
             "--trace", "0"], cwd=cwd, capture_output=True, text=True,
            env=env)
        assert p.returncode != 0 and p.stdout == ""
