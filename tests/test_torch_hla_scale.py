"""HLA-style panels through both command lines, `add` then `genotype`.

The world of `chip_smoke.py` (g) (`extra/hla_scale.py`'s panel) at a small
size: 2 loci of 2 kb, each 20 haplotypes in 4 clades (0.3 % divergence
within a clade, 2 % between them), 15x pairs from each true genotype plus
15x background from the three 10 kb flanks.  Each package's `sim.py` builds
it from one numpy seed, and the two builds must be equal.  Each package's
`add` writes its own database from the same files; each package's
`genotype` reads it, with one saved background and one scheme.  On the CPU
the JAX package's `auto` engine is its sequential one and the port's the
chains annealer (ROADMAP "Departures by design"), so only the called
genotypes are compared: equal to each other and to the truth.
"""
import gzip
import json

import numpy as np
import pytest
import torch

from locityper_tpu import cli as jcli
from locityper_tpu import sim as jsim
from locityper_tpu_torch import cli as tcli
from locityper_tpu_torch import sim as tsim
from locityper_tpu_torch.bg import BgDistr, SequencingInfo, Technology
from locityper_tpu_torch.bg.depth import ReadDepth
from locityper_tpu_torch.bg.err_prof import ErrorProfile
from locityper_tpu_torch.bg.insertsz import InsertDistr
from locityper_tpu_torch.mathx.distr import NBinom
from locityper_tpu_torch.seq import fastx
from locityper_tpu_torch.utils import paths
from locityper_tpu_torch.utils.io import smart_create

torch.set_num_threads(1)        # the suite runs several workers side by side

SCHEME = ["-S", "greedy:i=5k,a=1", "anneal:i=8,a=8,n=3000,p=2000"]
N_LOCI, DEPTH = 2, 15.0


def build_world(sim, seed):
    """`extra/hla_scale.py:build_panel`'s steps with `sim`, at a small
    size: (loci, genome, (names, reads1, reads2))."""
    rng = np.random.default_rng(seed)
    loci = [sim.simulate_structured_locus(
        rng, f"HLA{i}", length=2000, n_clades=4, haps_per_clade=5,
        clade_divergence=0.02, within_divergence=0.003)
        for i in range(N_LOCI)]
    flanks = [sim.random_genome(rng, 10_000) for _ in range(N_LOCI + 1)]
    genome = np.concatenate(
        [p for pair in zip(flanks, [lc.haplotypes[0] for lc in loci])
         for p in pair] + [flanks[-1]])
    err = sim.ErrorModel(0.002, 0.0002, 0.0002)
    pools = [sim.simulate_paired_reads(
        rng, [lc.haplotypes[i] for i in lc.true_genotype], depth=DEPTH,
        read_len=150, errors=err, prefix=lc.name) for lc in loci]
    pools.append(sim.simulate_paired_reads(rng, flanks, depth=DEPTH,
                                           read_len=150, errors=err,
                                           prefix="bg"))
    return loci, genome, tuple([x for p in pools for x in getattr(p, f)]
                               for f in ("names", "reads1", "reads2"))


def make_bg(read_len=150.0, window=100):
    """Background distributions of the simulator's settings (chip_smoke.py's
    `make_bg`)."""
    err = ErrorProfile.estimate(997600, 2000, 200, 200,
                                [(0, 150, 100.0), (1, 150, 50.0)])
    ins = InsertDistr.from_nbinom(NBinom.estimate(400.0, 4000.0))
    hap_m = DEPTH * window / (2 * read_len) / 2.0
    depth = ReadDepth(2, window, 300,
                      [NBinom.estimate(hap_m, hap_m * 1.6)] * 101)
    return BgDistr(SequencingInfo(read_len, Technology.ILLUMINA), ins, err,
                   depth)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("hla_scale")
    loci, genome, (names, reads1, reads2) = build_world(tsim, 0)
    j_loci, j_genome, j_reads = build_world(jsim, 0)
    assert np.array_equal(genome, j_genome)
    for lc, jl in zip(loci, j_loci):
        assert lc.true_genotype == jl.true_genotype
        assert lc.hap_names == jl.hap_names
        assert all(np.array_equal(a, b)
                   for a, b in zip(lc.haplotypes, jl.haplotypes))
    assert names == j_reads[0] and all(
        np.array_equal(a, b) for a, b in zip(reads1 + reads2,
                                             j_reads[1] + j_reads[2]))
    with open(root / "ref.fa", "w") as f:
        fastx.write_fasta(f, "chr1", genome)
    rows, pos = [], 0
    for lc in loci:
        pos += 10_000
        end = pos + lc.haplotypes[0].size
        assert np.array_equal(genome[pos:end], lc.haplotypes[0])
        rows.append(f"chr1\t{pos}\t{end}\t{lc.name}\n")
        pos = end
        with open(root / f"haps_{lc.name}.fa", "w") as f:
            for name, seq in zip(lc.hap_names, lc.haplotypes):
                fastx.write_fasta(f, name, seq)
    (root / "loci.bed").write_text("".join(rows))
    r1, r2 = root / "reads_1.fq.gz", root / "reads_2.fq.gz"
    with smart_create(r1) as f1, smart_create(r2) as f2:
        for n, a, b in zip(names, reads1, reads2):
            fastx.write_fastq(f1, fastx.Read(n, a))
            fastx.write_fastq(f2, fastx.Read(n, b))
    prep = root / "sample"
    paths.bg_dir(prep).mkdir(parents=True)
    make_bg().save(paths.bg_dir(prep) / paths.BG_DISTR)
    return root, loci, r1, r2, prep


@pytest.fixture(scope="module")
def calls(world):
    """{(package, locus): called haplotype names} of both command lines."""
    root, loci, r1, r2, prep = world
    out_calls = {}
    for key, main, device in (("jax", jcli.main, []),
                              ("torch", tcli.main, ["--device", "cpu"])):
        db, out = root / f"db_{key}", root / f"out_{key}"
        assert main([*device, "add", "-d", str(db), "-r",
                     str(root / "ref.fa"), "-l", str(root / "loci.bed"),
                     "-s", str(root / "haps_{}.fa")]) == 0
        assert main([*device, "genotype", "-i", str(r1), str(r2), "-d",
                     str(db), "-p", str(prep), "-o", str(out), *SCHEME,
                     "--seed", "1"]) == 0
        for lc in loci:
            with gzip.open(paths.locus_dir(out, lc.name) / paths.RES_JSON,
                           "rt") as f:
                out_calls[key, lc.name] = sorted(json.load(f)["genotype"]
                                                 .split(","))
    return out_calls


@pytest.mark.parametrize("i", range(N_LOCI))
def test_both_command_lines_call_the_truth(world, calls, i):
    lc = world[1][i]
    truth = sorted(lc.hap_names[j] for j in lc.true_genotype)
    assert calls["torch", lc.name] == calls["jax", lc.name] == truth, calls
