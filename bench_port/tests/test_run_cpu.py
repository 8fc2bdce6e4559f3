"""A whole run past the look for a card, on the CPU with the kernels' plain
versions, at a small size: sound, it is correct; with a fault planted
under the timed path, it is not."""
import json
import os
import shutil
from pathlib import Path

import pytest

from bench_port import control, run

ROOT = Path(run.__file__).resolve().parents[1]
#: A shorter scheme than genotype's default keeps the plain annealer's
#: run on the CPU to seconds.
SHORT = ["-S", "greedy:i=5k,a=1,p=500", "anneal:i=20,a=20,n=1k,p=500"]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A checkout whose one cell is hla_abc_sr cut to 2 loci of 6
    haplotypes, reporting the fresh command-line process too."""
    root = tmp_path_factory.mktemp("tiny")
    shutil.copytree(ROOT / "bench_port", root / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.loads((ROOT / "bench_port/configs/hla_abc_sr.json")
                     .read_text())
    cfg["name"] = "tiny"
    cfg["panel"].update(n_loci=2, n_clades=3, haps_per_clade=2)
    cfg["flank_len"] = 6000
    (root / "bench_port/configs/tiny.json").write_text(json.dumps(cfg))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [dict(bench["configs"][0], name="tiny",
                             file="bench_port/configs/tiny.json")]
    bench["workloads"] = [dict(bench["workloads"][0], name="tiny.locus_reads",
                               config="tiny")]
    # The tiny cell also reports the fresh command-line process.
    bench["end_to_end"].append({"name": "cli_sample_s", "unit": "s",
                                "better": "lower", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["tiny.locus_reads"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copy(ROOT / "bench_port/limits/hla_abc_sr.locus_reads.json",
                root / "bench_port/limits/tiny.locus_reads.json")
    return run.Spec("tiny.locus_reads", root / "BENCHMARK.json")


@pytest.mark.parametrize("fault", [None, *control.FAULTS])
def test_a_run_is_correct_only_when_sound(tiny, fault, monkeypatch):
    orig = run.Cell.genotype_args
    monkeypatch.setattr(run.Cell, "genotype_args",
                        lambda self, s, out: orig(self, s, out) + SHORT)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    # A window of two calls or more: the command line's call, in a process
    # of its own, is never faulted.
    seconds = 10.0
    if fault is None:
        result = run.run(tiny, 2**40 + 1, seconds, False, env, device="cpu")
        assert result["correct"] and result["failed"] == 0
        assert set(result["metrics"]) == {
            m["name"] for m in tiny.metrics("end_to_end")} \
            == {"setup_s", "sample_s", "cli_sample_s"}
        assert list(result)[-1] == "checks"
        return
    with control.fault(fault):
        result = run.run(tiny, 2**40 + 1, seconds, False, env, device="cpu")
    assert result["attempted"] >= 2
    assert not result["correct"], result["checks"]
