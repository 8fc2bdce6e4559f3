"""`genotype` options of the port's command line against the JAX package's,
on the CPU.

The world of tests/test_torch_genotype_cmd.py (two loci on one contig, a
paired sample from their true genotypes plus background; database and
background distributions written by the JAX package).  Each case runs both
packages' `genotype` on the same files, the port with `--device cpu` (the
plain PyTorch versions of the kernels):

- `_apply_param_args`: one argv that sets every knob gives equal `Params`,
  field by field;
- recruitment options (`-m`, `-M`, `-L`, `--kmer-thresh`, `--interleaved`)
  with `--stop-after recruit`: the recruited reads are equal, name by name
  and in order (recruitment is integers only).  `-m 16,10` runs the front
  end at 32-bit k-mers; `-m 17,10` raises the same exception in both;
- `--priors`: the file defines the genotype list; equal calls, the same
  options in the same order, likelihoods within tests/test_torch_pipeline.py's
  tolerance; a positive prior is refused alike;
- the model and filter knobs, and `--debug 2`: equal calls, the top
  likelihood within the same tolerance, the same debug files, with
  `windows.bed.gz` equal byte for byte.

The two annealers draw different random numbers, so calls are compared for
equality and likelihoods within a tolerance.
"""
import argparse
import dataclasses
import gzip
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from locityper_tpu import cli as jcli
from locityper_tpu.commands import genotype as JG
from locityper_tpu.model import Params as JParams
from locityper_tpu.seq import fastx
from locityper_tpu.utils.io import smart_create
from locityper_tpu_torch.commands import genotype as TG
from locityper_tpu_torch.model import Params as TParams

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_genotype_cmd import (LOCI, SCHEME, fastq_records,  # noqa: E402
                                     read_json, torch_cli, world)

torch.set_num_threads(1)        # the suite runs several workers side by side

LN10 = float(np.log(10.0))
KNOBS = ["--skew", "0.8", "-D", "3", "-U", "-8", "-A", "0.5", "2", "3",
         "--complexity", "6", "--kmers-weight", "0.3,3", "--compl-weight",
         "0.4,3", "--min-weight", "0.01", "--read-kmers", "1,6", "-t", "40",
         "--filt-diff", "50", "--prob-thresh", "-3", "--dont-skip"]


def tcli_main(argv):
    """The port's command line on the CPU, called as `cli.main` is."""
    return torch_cli(*argv)


def parse_genotype(add_args, argv):
    p = argparse.ArgumentParser()
    add_args(p)
    return p.parse_args(["-d", "db", "-p", "prep", "-o", "out", *argv])


def test_apply_param_args_sets_equal_params():
    """Every knob of the command line reaches the same field of `Params`,
    with the same log10 -> ln conversion, in both packages."""
    j = JG._apply_param_args(JParams(), parse_genotype(JG.add_args, KNOBS))
    t = TG._apply_param_args(TParams(), parse_genotype(TG.add_args, KNOBS))
    jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
    assert jd.keys() == td.keys()
    for field in jd:
        assert td[field] == jd[field], field
    # Every knob moved its field off the default.
    default = dataclasses.asdict(TParams())
    moved = {f for f in td if td[f] != default[f]}
    assert moved == {
        "lik_skew", "prob_diff", "unmapped_penalty", "alt_cn",
        "complexity_k", "kmers_weight_breakpoint", "kmers_weight_power",
        "compl_weight_breakpoint", "compl_weight_power", "min_weight",
        "kmer_soft_thresh", "tweak", "filt_diff", "prob_thresh",
        "dont_skip"}
    assert t.unmapped_penalty == pytest.approx(-8 * LN10)
    assert t.alt_cn == (0.5, 2.0, 3.0)


# --- recruitment options ----------------------------------------------------

def recruit_both(world, out, inputs, extra):
    """`genotype --stop-after recruit` of both packages into out/j, out/t;
    returns {locus: (JAX records, port records)}."""
    args = [*inputs, "-d", str(world.db), "-p", str(world.prep), *extra]
    assert jcli.main(["genotype", *args, "-o", str(out / "j"),
                      "--stop-after", "recruit"]) == 0
    assert torch_cli("genotype", *args, "-o", out / "t",
                     "--stop-after", "recruit") == 0
    return {name: tuple(fastq_records(out / side / "loci" / name
                                      / "reads.fq.gz") for side in "jt")
            for name in LOCI}


@pytest.fixture(scope="module")
def interleaved(world):
    path = world.root / "reads_interleaved.fq.gz"
    with smart_create(path) as f:
        for name, c1, c2 in world.reads:
            fastx.write_fastq(f, fastx.Read(name, c1))
            fastx.write_fastq(f, fastx.Read(name, c2))
    return path


@pytest.mark.parametrize("case", ["m13", "m16", "match", "interleaved"])
def test_recruitment_options_equal(world, interleaved, tmp_path, case):
    inputs = ["-i", str(world.r1), str(world.r2)]
    extra = {"m13": ["-m", "13,7"], "m16": ["-m", "16,10"],
             "match": ["-M", "0.6", "-L", "1000", "--kmer-thresh", "5"],
             "interleaved": ["--interleaved"]}[case]
    if case == "interleaved":
        inputs = ["-i", str(interleaved)]
    got = recruit_both(world, tmp_path, inputs, extra)
    for name in LOCI:
        j_recs, t_recs = got[name]
        assert t_recs == j_recs, name
        assert sum(n.startswith(name) for n, _ in t_recs) > 300, name
    if case == "interleaved":
        # One interleaved file recruits what the two files do.
        assert torch_cli("genotype", "-i", world.r1, world.r2, "-d",
                         world.db, "-p", world.prep, "-o", tmp_path / "two",
                         "--stop-after", "recruit") == 0
        for name in LOCI:
            assert fastq_records(tmp_path / "two" / "loci" / name
                                 / "reads.fq.gz") == got[name][1], name


def test_minimizer_k17_fails_alike(world, tmp_path):
    """k = 17 does not fit the 32-bit k-mers of either package's index."""
    args = ["-i", str(world.r1), str(world.r2), "-d", str(world.db), "-p",
            str(world.prep), "-m", "17,10", "--stop-after", "recruit"]
    raised = []
    for main, out in ((jcli.main, "j"), (tcli_main, "t")):
        with pytest.raises(Exception) as e:
            main(["genotype", *args, "-o", str(tmp_path / out)])
        raised.append(type(e.value))
    assert raised[0] is raised[1] is AssertionError


# --- the model: priors, knobs, debug files -----------------------------------

def run_both(world, out, extra):
    """Full `genotype` of both packages (SCHEME, seed 5) into out/j, out/t;
    returns {locus: (JAX res.json, port res.json)}."""
    args = world.base + SCHEME + ["--seed", "5", *extra]
    assert jcli.main(["genotype", *args, "-o", str(out / "j")]) == 0
    assert torch_cli("genotype", *args, "-o", out / "t") == 0
    return {name: tuple(read_json(out / side / "loci" / name / "res.json.gz")
                        for side in "jt") for name in LOCI}


def assert_same_top(name, j_res, t_res, truth):
    """Equal calls, equal to the truth; the top option's likelihood within
    4 standard errors of the two means over their 8 attempts + 1.0 ln
    units (tests/test_torch_pipeline.py)."""
    assert sorted(t_res["genotype"].split(",")) == truth, (name, t_res)
    assert t_res["genotype"] == j_res["genotype"], name
    a, b = t_res["options"][0], j_res["options"][0]
    limit = 4.0 * np.sqrt(a["lik_sd"] * LN10 / 8
                          + b["lik_sd"] * LN10 / 8) + 1.0
    assert abs(a["lik_mean"] - b["lik_mean"]) * LN10 <= limit, name


def write_priors(world, path):
    """For each locus: the truth at 0, two other genotypes at -1 and -2,
    one at -inf (log10).  Returns {locus: the finite genotypes}."""
    listed = {}
    lines = []
    for lc in world.loci:
        names = lc.hap_names
        truth = ",".join(world.truth[lc.name])
        others = [f"{names[a]},{names[b]}" for a in range(len(names))
                  for b in range(a, len(names))
                  if sorted((names[a], names[b])) != world.truth[lc.name]]
        lines += [f"{lc.name}\t{truth}\t0", f"{lc.name}\t{others[0]}\t-1",
                  f"{lc.name}\t{others[1]}\t-2",
                  f"{lc.name}\t{others[2]}\t-inf"]
        listed[lc.name] = {truth, others[0], others[1]}
    path.write_text("\n".join(lines) + "\n")
    return listed


def test_priors_define_the_genotypes(world, tmp_path):
    listed = write_priors(world, tmp_path / "priors.tsv")
    got = run_both(world, tmp_path, ["--priors", str(tmp_path / "priors.tsv")])
    for name in LOCI:
        j_res, t_res = got[name]
        assert_same_top(name, j_res, t_res, world.truth[name])
        t_opts = [o["genotype"] for o in t_res["options"]]
        assert t_opts == [o["genotype"] for o in j_res["options"]], name
        assert {",".join(sorted(g.split(","))) for g in t_opts} == \
            {",".join(sorted(g.split(","))) for g in listed[name]}, name


def test_positive_prior_is_refused_alike(world, tmp_path):
    lc = world.loci[0]
    (tmp_path / "bad.tsv").write_text(
        f"{lc.name}\t{','.join(world.truth[lc.name])}\t0.5\n")
    args = world.base + ["--priors", str(tmp_path / "bad.tsv")]
    messages = []
    for main, out in ((jcli.main, "j"), (tcli_main, "t")):
        with pytest.raises(SystemExit) as e:
            main(["genotype", *args, "-o", str(tmp_path / out)])
        messages.append(str(e.value))
    assert messages[0] == messages[1] and "0.5" in messages[0]


def rows_of(path):
    with gzip.open(path, "rt") as f:
        return [line.rstrip("\n").split("\t") for line in f]


@pytest.mark.parametrize("case", ["model", "filter_debug"])
def test_model_and_filter_knobs(world, tmp_path, case):
    extra = {"model": ["-A", "0.5", "2", "3", "-U", "-8", "--tweak", "40",
                       "--min-weight", "0.01", "--kmers-weight", "0.3,3",
                       "--compl-weight", "0.4,3", "--read-kmers", "1,6"],
             "filter_debug": ["--filt-diff", "50", "--prob-thresh", "-3",
                              "--dont-skip", "--debug", "2"]}[case]
    got = run_both(world, tmp_path, extra)
    for name in LOCI:
        assert_same_top(name, *got[name], world.truth[name])
    if case != "filter_debug":
        return
    for name in LOCI:
        j_dir, t_dir = (tmp_path / side / "loci" / name for side in "jt")
        files = {p.name for p in t_dir.iterdir()}
        assert files == {p.name for p in j_dir.iterdir()}, name
        assert {"windows.bed.gz", "sol.csv.gz", "read_pairs.csv.gz"} <= files
        assert gzip.decompress((t_dir / "windows.bed.gz").read_bytes()) == \
            gzip.decompress((j_dir / "windows.bed.gz").read_bytes()), name
        # The annealers' values may differ; the columns and the genotypes
        # (stage, genotype) and candidate locations (read, contig) may not.
        for fn, keys in (("sol.csv.gz", (0, 1)),
                         ("read_pairs.csv.gz", (0, 3))):
            t_rows, j_rows = rows_of(t_dir / fn), rows_of(j_dir / fn)
            assert t_rows[0] == j_rows[0], (name, fn)
            assert sorted(tuple(r[i] for i in keys) for r in t_rows[1:]) == \
                sorted(tuple(r[i] for i in keys) for r in j_rows[1:]), \
                (name, fn)
            assert len(t_rows) > 10, (name, fn)
