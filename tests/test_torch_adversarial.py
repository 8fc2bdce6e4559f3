"""The adversarial cases of tests/test_adversarial.py through the port,
against the JAX package, on the CPU (BASELINE.json config 3's stress:
recruitment specificity and the depth model).

- twins: each true haplotype has same-clade siblings at 0.3 % divergence;
- paralog: a diploid copy of the locus at 97 % or 99 % identity elsewhere
  in the genome sheds reads that recruitment pulls in (`sim.make_paralog`,
  the CYP2D6/CYP2D7 case), and the off-target k-mer counts see it;
- gc: GC-biased fragment acceptance over an isochore-structured locus, with
  the matched per-GC-bin depth model (the 101 GC bins carry the call).

Each sample is drawn exactly as the JAX test draws it.  Recruitment is
integers only: the port's device path (`pipeline.recruit_records` on
`device="cpu"`, the plain version of its kernel) must keep, name by name,
the reads of the JAX package's device path and of the port's per-read
oracle on reads padded as a device row pads them, and the two host engines
(the JAX package's `recruit_reads` without its device, the port's
`pipeline.recruit_reads`) the same reads as each other (`recruit`).  Calls
must equal the truth and the JAX package's.  Both packages run on the first
seed of each case, once, in a module-scoped fixture; the second seed runs
through the port alone (the JAX side of it is tests/test_adversarial.py).
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from locityper_tpu import sim
from locityper_tpu.commands.genotype import recruit_reads as j_recruit_reads
from locityper_tpu.pipeline import genotype_locus as j_genotype_locus
from locityper_tpu.seq.recruit import RecruitParams as JRecruitParams
from locityper_tpu.solvers.solve import Scheme as JScheme
from locityper_tpu_torch import convert
from locityper_tpu_torch import pipeline as tpipeline
from locityper_tpu_torch.pipeline import genotype_locus
from locityper_tpu_torch.seq.recruit import RecruitParams
from locityper_tpu_torch.solvers.solve import Scheme

sys.path.insert(0, str(Path(__file__).parent))
from test_adversarial import ERR, locus_data, make_bg  # noqa: E402
from test_torch_pipeline import lik_spread  # noqa: E402

torch.set_num_threads(1)        # the suite runs several workers side by side

SCHEME = ["greedy:i=5k,a=1", "anneal:i=8,a=8,n=3000,p=2000"]
MATCH_FRAC = 0.6                # tests/test_adversarial.py's recruitment
PAD = 9                         # minimizer_w - 1: a device row's padding


def twins(seed):
    """tests/test_adversarial.py:62-82."""
    rng = np.random.default_rng(100 + seed)
    locus = sim.simulate_structured_locus(
        rng, "NI", length=5000, n_clades=3, haps_per_clade=3,
        clade_divergence=0.02, within_divergence=0.003)
    data = locus_data(locus)
    reads = sim.simulate_paired_reads(
        rng, [locus.haplotypes[i] for i in locus.true_genotype],
        depth=18.0, errors=ERR)
    return dict(locus=locus, data=data, bg=make_bg(depth_per_hap=18.0),
                reads=list(zip(reads.names, reads.reads1, reads.reads2)),
                recruit_first=False)


def paralog(seed):
    """tests/test_adversarial.py:86-132: 97 % identity at seed 0, 99 % at
    seed 1; the decoy in both sample haplotypes (2 x 16x)."""
    identity = (0.97, 0.99)[seed]
    rng = np.random.default_rng(200 + seed)
    locus = sim.simulate_locus(rng, "PD", length=4000, n_haps=5,
                               divergence=0.015)
    decoy = sim.make_paralog(rng, locus.haplotypes[0], identity=identity)
    data = locus_data(locus, genome_extra=[decoy])
    rd_true = sim.simulate_paired_reads(
        rng, [locus.haplotypes[i] for i in locus.true_genotype], depth=16.0,
        errors=ERR, prefix="t")
    rd_decoy = sim.simulate_paired_reads(rng, [decoy, decoy], depth=16.0,
                                         errors=ERR, prefix="d")
    rd_bg = sim.simulate_paired_reads(
        rng, [sim.random_genome(rng, 20000)], depth=16.0, errors=ERR,
        prefix="b")
    names = rd_true.names + rd_decoy.names + rd_bg.names
    all1 = rd_true.reads1 + rd_decoy.reads1 + rd_bg.reads1
    all2 = rd_true.reads2 + rd_decoy.reads2 + rd_bg.reads2
    order = np.random.default_rng(seed).permutation(len(names))
    return dict(locus=locus, data=data, bg=make_bg(depth_per_hap=16.0),
                reads=[(names[i], all1[i], all2[i]) for i in order],
                recruit_first=True)


def gc_biased(seed):
    """tests/test_adversarial.py:136-160."""
    rng = np.random.default_rng(300 + seed)
    base = sim.random_genome_gc(rng, 4500, gc_low=0.25, gc_high=0.70)
    locus = sim.simulate_locus(rng, "GC", n_haps=5, divergence=0.015,
                               base=base)
    data = locus_data(locus)
    curve = sim.gc_bias_curve(strength=0.8, center=0.45)
    reads = sim.simulate_paired_reads(
        rng, [locus.haplotypes[i] for i in locus.true_genotype],
        depth=26.0, errors=ERR, gc_bias=curve)
    assert len(reads.reads1) < 26.0 * 2 * 4500 / (2 * 150)
    return dict(locus=locus, data=data,
                bg=make_bg(depth_per_hap=26.0, gc_curve=curve),
                reads=list(zip(reads.names, reads.reads1, reads.reads2)),
                recruit_first=False)


CASES = {"twins": twins, "paralog": paralog, "gc": gc_biased}


def recruit(case):
    """Both packages' recruitment of one sample.  The device paths (the
    JAX package's and the port's on `device="cpu"`) keep the same reads,
    name by name and in order, and equal the port's per-read oracle on
    padded reads; the host engines keep the same reads as each other.
    The two kinds differ by design (ROADMAP Queue C item 10): a device
    row pads the read with N, which moves the windows at its end, and on
    the paralog's borderline reads that moves dozens of pairs (50 of 572
    at 97 % identity), in both packages alike.  Returns the port's device
    path's (read_pairs, names) and the count that the padding moved."""
    name = case["locus"].name
    j_data = {name: case["data"]}
    data = {name: convert.from_reference(case["data"])}
    j_rp, rp = JRecruitParams(match_frac=MATCH_FRAC), \
        RecruitParams(match_frac=MATCH_FRAC)
    j_dev, _ = j_recruit_reads(j_data, iter(case["reads"]), j_rp, batch=512)
    j_host, _ = j_recruit_reads(j_data, iter(case["reads"]), j_rp,
                                batch=512, use_device=False)
    rec, _ = tpipeline.recruit_records(data, iter(case["reads"]), rp,
                                       batch=512, device="cpu")
    host = tpipeline.recruit_reads(data, iter(case["reads"]), rp)
    oracle = tpipeline.recruit_reads(data, iter(case["reads"]), rp, pad=PAD)
    pairs, names = rec[name]
    assert names == j_dev[name][1] == oracle[name][1]
    for (a1, a2), (b1, b2) in zip(pairs, j_dev[name][0]):
        np.testing.assert_array_equal(a1, b1)
        np.testing.assert_array_equal(a2, b2)
    assert host[name][1] == j_host[name][1]
    assert len(names) > 0
    return pairs, names, len(set(names) ^ set(host[name][1]))


def genotype_port(case, pairs, names, seed):
    res, _ = genotype_locus(
        convert.from_reference(case["data"]), pairs, names,
        convert.from_reference(case["bg"]), scheme=Scheme.parse(SCHEME),
        seed=seed, device="cpu")
    return res


def inputs(case):
    """The reads that go to `genotype_locus`: the recruited ones where the
    JAX test recruits (the paralog case: the device path's, as the command
    line takes them), else every simulated pair."""
    pairs, names, moved = recruit(case)
    if not case["recruit_first"]:
        pairs = [(a, b) for _, a, b in case["reads"]]
        names = [n for n, _, _ in case["reads"]]
    return pairs, names, moved


@pytest.fixture(scope="module", params=list(CASES))
def solved(request):
    """Both packages on the first seed of one case."""
    seed = 0
    case = CASES[request.param](seed)
    pairs, names, moved = inputs(case)
    print(f"{request.param}: {len(names)} pairs to genotype, the padding "
          f"moved {moved}")
    j_res, _ = j_genotype_locus(case["data"], pairs, names, case["bg"],
                                scheme=JScheme.parse(SCHEME), seed=seed)
    res = genotype_port(case, pairs, names, seed)
    return dict(case, kind=request.param, names=names, res=res, j_res=j_res)


def call_of(res):
    return tuple(sorted(int(h) for h in res.genotypes[0]))


def test_calls_equal_truth_and_reference(solved):
    truth = solved["locus"].true_genotype
    res, j_res = solved["res"], solved["j_res"]
    assert call_of(res) == truth, (
        solved["kind"], call_of(res), truth,
        [tuple(g) for g in res.genotypes[:5]])
    assert call_of(res) == call_of(j_res)
    assert res.total_reads == j_res.total_reads
    assert res.unexpl_reads == j_res.unexpl_reads
    pa, pb = res.predictions[0], j_res.predictions[0]
    print(f"{solved['kind']}: lik_mean port {pa.lik_mean:.3f}, reference "
          f"{pb.lik_mean:.3f}, limit {lik_spread(pa, pb):.3f}")
    assert pa.lik_mean == pytest.approx(pb.lik_mean, abs=lik_spread(pa, pb))


def test_paralog_is_a_stress(solved):
    """The decoy's reads were recruited (else the case tests nothing), and
    the other two cases recruit every pair of the locus."""
    n_decoy = sum(n.startswith("d") for n in solved["names"])
    if solved["kind"] == "paralog":
        assert n_decoy > 0
    else:
        assert len(solved["names"]) > 0.95 * len(solved["reads"])


@pytest.mark.parametrize("kind", list(CASES))
def test_second_seed_port_alone(kind):
    """The second seed of each case (99 % identity for the paralog): the
    recruited reads equal the JAX host engine's, and the port's call the
    truth."""
    seed = 1
    case = CASES[kind](seed)
    pairs, names, _ = inputs(case)
    if kind == "paralog":
        assert sum(n.startswith("d") for n in names) > 0
    res = genotype_port(case, pairs, names, seed)
    assert call_of(res) == case["locus"].true_genotype, (
        kind, call_of(res), case["locus"].true_genotype)
