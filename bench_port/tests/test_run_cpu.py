"""A whole run past the look for a card, on the CPU with the kernels' plain
versions, at a small size: sound, it is correct; with a fault planted
under the timed path, it is not.  `tiny` is a cell of pairs, `tiny_long`
one of single long reads over a paralog locus, added as data files only."""
import contextlib
import json
import os
import shutil
from pathlib import Path

import pytest

from bench_port import control, run

ROOT = Path(run.__file__).resolve().parents[1]
#: A shorter scheme than genotype's default keeps the plain annealer's
#: run on the CPU to seconds: the tiny configurations' `genotype_options`.
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
    cfg["genotype_options"] = SHORT
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
def test_a_run_is_correct_only_when_sound(tiny, fault):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    # A window of two calls or more: the command line's call, in a process
    # of its own, is never faulted.
    seconds = 20.0
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


#: The number each fault fails.
OWN = {"unchanged_state": "unpolished_share", "half_batch": "recruit_diff",
       "altered_call": "wrong_call_share"}
LONG_BG = {
    "seq_info": {"read_len": 2000.0, "technology": "ont",
                 "total_reads": None, "file_size": None},
    "error_profile": {"matches": -0.03719437000804904,
                      "mismatches": -3.8979240810486444,
                      "insertions": -4.814214812922799,
                      "deletions": -4.814214812922799,
                      "clipping": -3.8979240810486444,
                      "alpha": 3781.3197253922517,
                      "beta": 99999.99711758862},
    "bg_depth": {"ploidy": 2, "window": 500, "neighb": 500, "gc_bins": 101,
                 "n": 2.5, "p": 0.6666666666666666}}


@pytest.fixture(scope="module")
def tiny_long(tmp_path_factory):
    """A checkout whose one cell is a paralog locus of 6 haplotypes, 1 kb
    margins, read by 2,000 +- 300-base ONT reads: a configuration, a
    traffic mix, a limits file and BENCHMARK.json, nothing else."""
    root = tmp_path_factory.mktemp("tiny_long")
    shutil.copytree(ROOT / "bench_port", root / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = {"name": "tiny_long",
           "panel": {"prefix": "CYP", "n_loci": 1, "locus_len": 2000,
                     "n_clades": 3, "haps_per_clade": 2,
                     "clade_divergence": 0.02, "within_divergence": 0.003,
                     "paralog": {"identity": 0.97, "spacer": 500,
                                 "margin": 1000}},
           "flank_len": 4000,
           "reads": {"technology": "ont", "read_len_mean": 2000,
                     "read_len_sd": 300, "mismatch": 0.02,
                     "insertion": 0.008, "deletion": 0.008},
           "genotype_options": SHORT}
    traffic = {"name": "tiny_ont", "samples": 2, "locus_depth": 8.0,
               "flank_multiple": 0.5,
               "background_model_from": "chip_smoke.py:make_bg_long(depth="
               "10.0, window=500) at a read length of 2,000 (edits 70 and "
               "78 a read)",
               "background_model": LONG_BG}
    (root / "bench_port/configs/tiny_long.json").write_text(json.dumps(cfg))
    (root / "bench_port/traffic/tiny_ont.json").write_text(
        json.dumps(traffic))
    shutil.copy(ROOT / "bench_port/limits/hla_abc_sr.locus_reads.json",
                root / "bench_port/limits/tiny_long.tiny_ont.json")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [dict(bench["configs"][0], name="tiny_long",
                             file="bench_port/configs/tiny_long.json",
                             reduced=[])]
    bench["workloads"] = [{"name": "tiny_long.tiny_ont",
                           "config": "tiny_long", "traffic": "tiny_ont",
                           "chips": 1, "why": "a test"}]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return run.Spec("tiny_long.tiny_ont", root / "BENCHMARK.json")


@pytest.mark.parametrize("fault", [None, *control.FAULTS])
def test_a_long_read_run_is_correct_only_when_sound(tiny_long, fault):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    with control.fault(fault) if fault else contextlib.nullcontext():
        result = run.run(tiny_long, 2**40 + 3, 1.0, False, env,
                         device="cpu")
    checks = result["checks"]
    if fault is None:
        assert result["correct"] and result["failed"] == 0, checks
        assert set(result["metrics"]) == {"setup_s", "sample_s"}
        return
    assert not result["correct"]
    assert checks[OWN[fault]]["value"] > checks[OWN[fault]]["limit"], checks
