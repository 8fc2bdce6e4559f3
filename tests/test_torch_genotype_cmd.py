"""The second slice of the port as a whole: the command line, FASTQ to
res.json.gz, against the JAX package's command line on the same files.

One world (the world of tests/test_cli.py with a second locus, so that the
panel-batched align and solve paths run): the JAX package's `add` and
`preproc` write the database and the background distributions once, and both
packages' `genotype` read them — that directory and `bg/distr.json.gz` are
the state carried across.  The port runs with `--device cpu` (the plain
PyTorch versions of the kernels).

Recruitment is integers only: the recruited reads are compared for equality,
names and sequences, in order.  The two annealers draw different random
numbers, so calls are compared for equality and likelihoods within the
tolerance of tests/test_torch_pipeline.py.  The port's own `add` →
`preproc` → `genotype` runs without that directory; `--stop-after map`
involves no solver, so its aln.bam and aln.sam.gz are compared with the JAX
package's record for record, and the writers of the called genotypes'
files (`write_sam`) at the function, on the same assignments.
"""
import gzip
import json
import shutil
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from locityper_tpu import cli as jcli
from locityper_tpu import sim
from locityper_tpu.seq import bam as jbam
from locityper_tpu.seq import fastx
from locityper_tpu.utils.io import smart_create
from locityper_tpu_torch import bg as tbg
from locityper_tpu_torch import cli as tcli
from locityper_tpu_torch import pipeline as tpipeline
from locityper_tpu_torch.commands import genotype as TG
from locityper_tpu_torch.seq import bam as tbam
from locityper_tpu_torch.seq import dna
from locityper_tpu_torch.seq.recruit import RecruitParams

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_preproc import assert_same_json  # noqa: E402

torch.set_num_threads(1)        # the suite runs several workers side by side

SCHEME = ["-S", "greedy:i=5k,a=1", "anneal:i=8,a=8,n=3000,p=2000"]
LIGHT = ["-S", "greedy:i=5k,a=1", "anneal:i=4,a=4,n=1000,p=500"]
LOCI = ("GENE1", "GENE2")


def torch_cli(*argv):
    return tcli.main(["--device", "cpu", *map(str, argv)])


def read_json(path):
    with gzip.open(path, "rt") as f:
        return json.load(f)


def fastq_records(path):
    return [(r.name, r.seq.tobytes()) for r in fastx.read_fastq(path)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Reference genome with two embedded loci, their haplotype panels, a
    paired WGS sample of the true genotypes plus background; database and
    background distributions written by the JAX package's CLI."""
    root = tmp_path_factory.mktemp("torchcli")
    rng = np.random.default_rng(123)
    loci = [sim.simulate_locus(rng, name, length=4000, n_haps=5,
                               divergence=0.015) for name in LOCI]
    flanks = [sim.random_genome(rng, n) for n in (120_000, 20_000, 60_000)]
    genome = np.concatenate([flanks[0], loci[0].haplotypes[0], flanks[1],
                             loci[1].haplotypes[0], flanks[2]])
    with open(root / "ref.fa", "w") as f:
        fastx.write_fasta(f, "chr1", genome)
    s1 = flanks[0].size
    s2 = s1 + 4000 + flanks[1].size
    (root / "loci.bed").write_text(
        f"chr1\t{s1}\t{s1 + loci[0].haplotypes[0].size}\tGENE1\n"
        f"chr1\t{s2}\t{s2 + loci[1].haplotypes[0].size}\tGENE2\n")
    for locus in loci:
        with open(root / f"haps_{locus.name}.fa", "w") as f:
            for name, seq in zip(locus.hap_names, locus.haplotypes):
                fastx.write_fasta(f, name, seq)
    err = sim.ErrorModel(0.002, 0.0002, 0.0002)
    pools = [sim.simulate_paired_reads(
        rng, [lc.haplotypes[i] for i in lc.true_genotype], depth=15.0,
        errors=err, prefix=lc.name) for lc in loci]
    pools.append(sim.simulate_paired_reads(rng, [genome], depth=4.0,
                                           errors=err, prefix="bg"))
    # Where each pair was drawn: its source sequence, the fragment's start
    # in it, and where the source starts on chr1 (the loci's haplotypes
    # are placed at their locus's start).
    sources = [([lc.haplotypes[i] for i in lc.true_genotype], start)
               for lc, start in zip(loci, (s1, s2))] + [([genome], 0)]
    frags = {name: (seqs[src], pos, start)
             for pool, (seqs, start) in zip(pools, sources)
             for name, src, pos in zip(pool.names, pool.source_hap,
                                     pool.source_pos)}
    names = [n for p in pools for n in p.names]
    all1 = [r for p in pools for r in p.reads1]
    all2 = [r for p in pools for r in p.reads2]
    order = rng.permutation(len(names))
    r1, r2 = root / "reads_1.fq.gz", root / "reads_2.fq.gz"
    with smart_create(r1) as f1, smart_create(r2) as f2:
        for i in order:
            fastx.write_fastq(f1, fastx.Read(names[i], all1[i]))
            fastx.write_fastq(f2, fastx.Read(names[i], all2[i]))
    db, prep = root / "db", root / "sample"
    assert jcli.main(["add", "-d", str(db), "-r", str(root / "ref.fa"),
                      "-l", str(root / "loci.bed"),
                      "-s", str(root / "haps_{}.fa")]) == 0
    assert jcli.main(["preproc", "-i", str(r1), str(r2),
                      "-r", str(root / "ref.fa"), "-o", str(prep),
                      "-b", "chr1:10000-110000", "--max-reads", "8000"]) == 0
    truth = {lc.name: sorted(lc.hap_names[i] for i in lc.true_genotype)
             for lc in loci}
    return SimpleNamespace(
        root=root, loci=loci, r1=r1, r2=r2, db=db, prep=prep, truth=truth,
        genome=genome, frags=frags,
        reads=[(names[i], all1[i], all2[i]) for i in order],
        base=["-i", str(r1), str(r2), "-d", str(db), "-p", str(prep)])


@pytest.fixture(scope="module")
def both(world):
    """Both command lines, twice each: `--stop-after recruit`, then the full
    run, which resumes from the reads.fq.gz checkpoints."""
    j_out, t_out = world.root / "j_out", world.root / "t_out"
    args = world.base + SCHEME + ["--seed", "5"]
    assert jcli.main(["genotype", *args, "-o", str(j_out),
                      "--stop-after", "recruit"]) == 0
    assert torch_cli("genotype", *args, "-o", t_out,
                     "--stop-after", "recruit") == 0
    recruited = {}
    for name in LOCI:
        j_fq = j_out / "loci" / name / "reads.fq.gz"
        t_fq = t_out / "loci" / name / "reads.fq.gz"
        assert j_fq.exists() and t_fq.exists()
        assert not (t_out / "loci" / name / "res.json.gz").exists()
        recruited[name] = (fastq_records(j_fq), fastq_records(t_fq))
    assert jcli.main(["genotype", *args, "-o", str(j_out)]) == 0
    assert torch_cli("genotype", *args, "-o", t_out) == 0
    return SimpleNamespace(j_out=j_out, t_out=t_out, recruited=recruited)


def test_recruited_reads_equal_in_order(world, both):
    for name in LOCI:
        j_recs, t_recs = both.recruited[name]
        assert t_recs == j_recs, name
        # The rest are background reads drawn from the locus's own copy
        # in the genome.
        n_own = sum(n.startswith(name) for n, _ in t_recs)
        assert n_own > 300 and n_own > 0.8 * len(t_recs)


def test_calls_equal_truth_and_reference(world, both):
    """Likelihood tolerance, as in tests/test_torch_pipeline.py: 4 standard
    errors of the two means over their 8 attempts, plus 1.0 ln units.
    res.json.gz stores `lik_mean` and the variance (`lik_sd`) divided by
    ln 10; both are taken back to ln units first."""
    ln10 = float(np.log(10.0))
    for name in LOCI:
        ldir = both.t_out / "loci" / name
        res = read_json(ldir / "res.json.gz")
        j_res = read_json(both.j_out / "loci" / name / "res.json.gz")
        assert sorted(res["genotype"].split(",")) == world.truth[name], res
        assert res["genotype"] == j_res["genotype"]
        assert set(res) == set(j_res)
        assert set(res["options"][0]) == set(j_res["options"][0])
        assert res["total_reads"] == j_res["total_reads"]
        assert res["unexpl_reads"] == j_res["unexpl_reads"]
        a, b = res["options"][0], j_res["options"][0]
        assert a["genotype"] == b["genotype"]
        limit = 4.0 * np.sqrt(a["lik_sd"] * ln10 / 8
                              + b["lik_sd"] * ln10 / 8) + 1.0
        gap = abs(a["lik_mean"] - b["lik_mean"]) * ln10
        print(f"{name}: lik_mean gap {gap:.3f} ln units, limit {limit:.3f}")
        assert gap <= limit
        assert res["quality"] > 10 and j_res["quality"] > 10
        assert (ldir / "success").exists()
        # The finished locus drops its checkpoint.
        assert not (ldir / "reads.fq.gz").exists()


def test_second_run_resumed_from_the_checkpoint(world, tmp_path, monkeypatch):
    out = tmp_path / "ckpt"
    args = world.base + LIGHT + ["--seed", "5", "-o", str(out)]
    assert torch_cli("genotype", *args, "--stop-after", "recruit") == 0
    ck = out / "loci" / "GENE1" / "reads.fq.gz"
    pairs, names = TG._load_recruited(ck.parent)
    assert len(pairs) == len(names) > 50
    assert all(c2 is not None for _, c2 in pairs)

    def no_recruit(*a, **k):
        raise AssertionError("recruitment ran despite the checkpoint")

    monkeypatch.setattr(TG, "recruit_reads_fast", no_recruit)
    monkeypatch.setattr(TG, "recruit_records", no_recruit)
    assert torch_cli("genotype", *args) == 0
    for name in LOCI:
        res = read_json(out / "loci" / name / "res.json.gz")
        assert sorted(res["genotype"].split(",")) == world.truth[name]
    assert not ck.exists()
    monkeypatch.undo()
    # Same parameters: a clean skip.  A changed knob aborts with guidance;
    # --rerun all starts clean and adopts the new parameters.
    assert torch_cli("genotype", *args) == 0
    assert torch_cli("genotype", *args, "--skew", "0.7") == 1
    assert torch_cli("genotype", *args, "--skew", "0.7", "--rerun",
                     "all") == 0
    assert torch_cli("genotype", *args, "--skew", "0.7") == 0


def test_in_list_leave_out_and_knobs(world, tmp_path):
    lst = tmp_path / "inputs.txt"
    lst.write_text(f"{world.r1}\n{world.r2}\n")
    locus = world.loci[0]
    lo = [locus.hap_names[i] for i in range(5)
          if i not in locus.true_genotype][:2]
    out = tmp_path / "out"
    assert torch_cli("genotype", "-I", lst, "-d", world.db, "-p", world.prep,
                     "-o", out, *LIGHT, "--loci", "GENE1", "--leave-out",
                     *lo, "--skew", "0.8", "-D", "2.5", "--seed", "5") == 0
    res = read_json(out / "loci" / "GENE1" / "res.json.gz")
    called = set(res["genotype"].split(","))
    assert not (called & set(lo))
    assert sorted(called) == world.truth["GENE1"]
    assert not (out / "loci" / "GENE2").exists()
    # Leaving out every haplotype is a user error: one line, code 1.
    assert torch_cli("genotype", *world.base, "-o", tmp_path / "o2",
                     "--loci", "GENE1", "--leave-out",
                     *locus.hap_names) == 1
    assert torch_cli("genotype", "-i", tmp_path / "x.cram", "-d", world.db,
                     "-p", world.prep, "-o", tmp_path / "o3") == 1


def bam_records(path):
    """Every record of a BAM, unmapped and secondary ones too."""
    return [(r.name, r.flag, r.ref_id, r.pos, r.mapq, r.cigar,
             r.seq.tobytes(), r.tags)
            for r in tbam.read_bam_records(path, keep_flags=0)]


def sam_lines(path):
    with gzip.open(path, "rt") as f:
        return f.read().splitlines()


def test_port_cli_add_preproc_genotype_calls_the_truth(world, tmp_path):
    """`add`, `preproc` and `genotype`, all through the port's command line:
    no file of the JAX package's.  The port's `bg/distr.json.gz` equals the
    one the JAX package wrote with the same flags (floats within a relative
    1e-9, as in tests/test_torch_preproc.py), and the JAX package's
    `genotype` reads it and calls the truth as well."""
    db, prep = tmp_path / "db", tmp_path / "sample"
    assert torch_cli("add", "-d", db, "-r", world.root / "ref.fa", "-l",
                     world.root / "loci.bed", "-s",
                     world.root / "haps_{}.fa") == 0
    assert torch_cli("preproc", "-i", world.r1, world.r2, "-r",
                     world.root / "ref.fa", "-o", prep, "-b",
                     "chr1:10000-110000", "--max-reads", "8000") == 0
    with gzip.open(prep / "bg" / "distr.json.gz", "rt") as f:
        t_distr = json.load(f)
    with gzip.open(world.prep / "bg" / "distr.json.gz", "rt") as f:
        j_distr = json.load(f)
    assert_same_json(j_distr, t_distr)
    args = ["-i", world.r1, world.r2, "-d", db, "-p", prep, *LIGHT,
            "--seed", "5"]
    assert torch_cli("genotype", *args, "-o", tmp_path / "t_out") == 0
    assert jcli.main(["genotype", *map(str, args), "-o",
                      str(tmp_path / "j_out"), "--loci", "GENE1"]) == 0
    for out, names in ((tmp_path / "t_out", LOCI),
                       (tmp_path / "j_out", ("GENE1",))):
        for name in names:
            res = read_json(out / "loci" / name / "res.json.gz")
            assert sorted(res["genotype"].split(",")) == world.truth[name]


def test_stop_after_map_equals_reference(world, tmp_path):
    """aln.bam and aln.sam.gz: every candidate alignment of every modeled
    read, equal to the JAX package's record for record."""
    j_out, t_out = tmp_path / "j", tmp_path / "t"
    assert jcli.main(["genotype", *world.base, "-o", str(j_out),
                      "--stop-after", "map"]) == 0
    assert torch_cli("genotype", *world.base, "-o", t_out,
                     "--stop-after", "map") == 0
    for name in LOCI:
        j_dir, t_dir = j_out / "loci" / name, t_out / "loci" / name
        assert not (t_dir / "res.json.gz").exists()
        j_sam, t_sam = sam_lines(j_dir / "aln.sam.gz"), \
            sam_lines(t_dir / "aln.sam.gz")
        assert t_sam == j_sam
        j_bam, t_bam = bam_records(j_dir / "aln.bam"), \
            bam_records(t_dir / "aln.bam")
        assert t_bam == j_bam
        n_body = sum(not line.startswith("@") for line in t_sam)
        assert len(t_bam) == n_body > 300


def test_write_sam_equals_reference(world, tmp_path):
    """Both packages' `write_sam` on the same genotype, locus tensors,
    alignments and assignments (random slots of 6 attempts, the unmapped
    slot included): the SAM text equal line for line, the BAM equal record
    for record."""
    from locityper_tpu.model import sam as jsam
    from locityper_tpu_torch.bg.err_prof import EditDistCache, EditThresh
    from locityper_tpu_torch.model import Params
    from locityper_tpu_torch.model import sam as tsam
    from locityper_tpu_torch.model.assgn import LocusTensors
    from locityper_tpu_torch.model.locs import build_all_alignments

    name = "GENE1"
    locus = TG.load_locus(world.db, name)
    bg = tbg.BgDistr.load(world.prep / "bg" / "distr.json.gz")
    pairs, names = tpipeline.recruit_reads(
        {name: locus}, iter(world.reads), RecruitParams(match_frac=0.5),
        pad=PAD)[name]
    params = Params(unmapped_penalty=bg.seq_info.technology
                    .default_unmapped_penalty())
    params.set_tweak_size(bg.depth.window_size)
    params.band = 48
    cache = EditDistCache(bg.err_prof, EditThresh.default_for(
        bg.seq_info.technology))
    all_alns, _ = build_all_alignments(pairs, names, locus.contig_set,
                                       locus.kmer_counts, bg, cache, params,
                                       device="cpu")
    tensors = LocusTensors.build(all_alns)
    lc = world.loci[0]
    gt = tuple(sorted(lc.true_genotype))
    rng = np.random.default_rng(9)
    assignments = rng.integers(0, len(gt) * tensors.kh + 1,
                               (6, all_alns.n_used)).astype(np.int32)
    cs = locus.contig_set
    kw = dict(read_weights=all_alns.weights_used, all_alns=all_alns,
              read_pairs=pairs, hap_seqs=cs.seqs,
              score_vec=bg.err_prof.score_vec(), band=params.band)
    for sam, side in ((jsam, "j"), (tsam, "t")):
        sam.write_sam([tmp_path / f"{side}.bam", tmp_path / f"{side}.sam.gz"],
                      gt, tensors, cs.contigs.names,
                      [s.size for s in cs.seqs], all_alns.names_used,
                      assignments, **kw)
    t_sam = sam_lines(tmp_path / "t.sam.gz")
    assert t_sam == sam_lines(tmp_path / "j.sam.gz")
    t_bam = bam_records(tmp_path / "t.bam")
    assert t_bam == bam_records(tmp_path / "j.bam")
    assert len(t_bam) == sum(not line.startswith("@") for line in t_sam)
    assert any(r[1] & 0x4 for r in t_bam) and any(r[5] for r in t_bam)


def test_out_sams_and_bams_are_written_and_parse(world, tmp_path):
    """`--out-sams 1 --out-bams 2`: 00.bam, 01.bam and 00.sam.gz under each
    locus's alns/, readable by the port's BAM reader, one record per mapped
    mate of every modeled read under the best genotype."""
    out = tmp_path / "out"
    assert torch_cli("genotype", *world.base, "-o", out, *LIGHT, "--seed",
                     "5", "--out-sams", "1", "--out-bams", "2") == 0
    for name in LOCI:
        alns = out / "loci" / name / "alns"
        assert sorted(p.name for p in alns.iterdir()) == \
            ["00.bam", "00.sam.gz", "01.bam"]
        res = read_json(out / "loci" / name / "res.json.gz")
        assert sorted(res["genotype"].split(",")) == world.truth[name]
        recs = bam_records(alns / "00.bam")
        body = [line.split("\t") for line in sam_lines(alns / "00.sam.gz")
                if not line.startswith("@")]
        assert [(r[0], r[1], r[3]) for r in recs] == \
            [(b[0], int(b[1]), int(b[3]) - 1) for b in body]
        modeled = {r[0] for r in recs}
        assert len(modeled) == res["total_reads"]
        for rname in modeled:
            mates = [r for r in recs if r[0] == rname]
            assert len(mates) in (1, 2)
            assert all(not r[1] & 0x4 for r in mates) or len(mates) == 1
        assert len(bam_records(alns / "01.bam")) > 0


@pytest.mark.parametrize("where", ["align", "solve"])
def test_panel_failure_raises_and_does_not_fall_back(world, tmp_path,
                                                     monkeypatch, where):
    """The reference package catches any exception of the panel-batched
    align and solve calls and carries on per locus; the port raises."""
    def boom(*a, **k):
        raise RuntimeError(f"simulated failure in the panel {where}")

    if where == "align":
        from locityper_tpu_torch.model import locs
        monkeypatch.setattr(locs, "build_all_alignments_panel", boom)
    else:
        monkeypatch.setattr(tpipeline, "genotype_panel", boom)
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match=f"panel {where}"):
        torch_cli("genotype", *world.base, "-o", out, *LIGHT)
    for name in LOCI:
        assert not (out / "loci" / name / "res.json.gz").exists()
        assert (out / "loci" / name / "reads.fq.gz").exists()


def test_per_locus_failure_is_counted(world, tmp_path, monkeypatch):
    """The per-locus `try` stays: it logs, and the command returns 1."""
    def boom(*a, **k):
        raise RuntimeError("simulated crash after recruitment")

    monkeypatch.setattr(TG, "genotype_locus", boom)
    out = tmp_path / "out"
    assert torch_cli("genotype", *world.base, "-o", out, *LIGHT,
                     "--loci", "GENE2") == 1
    assert (out / "loci" / "GENE2" / "reads.fq.gz").exists()
    assert not (out / "loci" / "GENE2" / "success").exists()


def test_cuda_is_the_default_device(world, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device|CUDA"):
        tcli.main(["genotype", *world.base, "-o", str(tmp_path / "o")])
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["recruit", "-i", str(world.r1), str(world.r2), "-s",
                   str(world.root / "haps_GENE1.fa"), "-o",
                   str(tmp_path / "r.fq")])


def test_profile_writes_a_chrome_trace(world, tmp_path):
    """The trace holds the call's steps as `record_function` ranges."""
    out, prof = tmp_path / "out", tmp_path / "prof"
    assert torch_cli("genotype", *world.base, "-o", out, "--loci", "GENE1",
                     "--stop-after", "recruit", "--profile", prof) == 0
    trace = json.loads((prof / "trace.json").read_text())
    assert trace["traceEvents"]
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"genotype", "entry.load", "recruit", "recruit.index",
            "recruit.parse", "recruit.dispatch", "recruit.decide",
            "recruit.scatter", "entry.write"} <= names


def union_s(intervals):
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        total += max(0.0, b - max(a, end))
        end = max(end, b)
    return total


@pytest.fixture(scope="module")
def traced_call(world, tmp_path_factory):
    """One panel-path call on the CPU, with what its recruitment returned,
    the rows given to the aligner and the chains of every annealer call
    recorded beside it; its closed spans, the call's last."""
    from locityper_tpu_torch.model import locs
    from locityper_tpu_torch.ops import solver_chains
    from locityper_tpu_torch.utils import spans
    seen = SimpleNamespace(recruited=None, k1_rows=[], k1_staged=[],
                           k1_assembled=[], chains=[])
    mp = pytest.MonkeyPatch()
    orig_rec, orig_disp = TG.recruit_reads_fast, locs.dispatch_align_batches
    orig_anneal = solver_chains.anneal_chains

    def recruit(*a, **k):
        seen.recruited, speed = orig_rec(*a, **k)
        return seen.recruited, speed

    def dispatch(jobs, score_vec, band, *a, **k):
        seen.k1_rows.append(len(jobs))
        seen.k1_staged.append(jobs.staged_nbytes(band))
        # What the host assembled for the same jobs before the job table:
        # reads, windows and lengths, J x (2 L + band + 4) bytes.
        seen.k1_assembled.append(len(jobs) * (2 * jobs.L + band + 4))
        return orig_disp(jobs, score_vec, band, *a, **k)

    def anneal(probs, winpk, *a, **k):
        seen.chains.append(winpk.shape[0])
        return orig_anneal(probs, winpk, *a, **k)

    mp.setattr(TG, "recruit_reads_fast", recruit)
    mp.setattr(locs, "dispatch_align_batches", dispatch)
    mp.setattr(solver_chains, "anneal_chains", anneal)
    try:
        out = tmp_path_factory.mktemp("spans") / "out"
        assert torch_cli("genotype", *world.base, "-o", out, *LIGHT) == 0
    finally:
        mp.undo()
    kept = spans.snapshot()
    root = kept[-1]
    assert root.name == "genotype"
    seen.root = root
    seen.spans = [s for s in kept if s.call == root.id and s is not root]
    return seen


def test_the_call_leaves_a_well_formed_tree(traced_call):
    root, kept = traced_call.root, traced_call.spans
    assert root.parent is None and root.call == root.id
    names = {s.name for s in kept}
    assert {"entry.load", "entry.write", "recruit", "recruit.index",
            "recruit.parse", "recruit.read", "recruit.mate",
            "recruit.dispatch", "recruit.decide", "recruit.scatter",
            "align", "align.vote", "align.jobs", "align.wait",
            "align.dispatch", "align.post", "solve", "solve.prep",
            "solve.filter", "solve.stage1", "solve.stage2",
            "solve.final"} <= names
    for s in kept:
        assert root.start <= s.start <= s.end <= root.end, s
        layer, dot, _ = s.name.partition(".")
        if not dot:
            assert s.parent is root, s
        elif layer == "entry":
            assert s.parent is root, s
        else:
            assert s.parent.name == layer and s.parent.call == root.id, s
    off_main = ("align.vote", "align.jobs", "recruit.read", "recruit.mate")
    workers = {s.thread for s in kept if s.name in off_main}
    assert workers and root.thread not in workers
    assert all(s.thread == root.thread for s in kept
               if s.name not in off_main)


def test_main_thread_steps_cover_the_call(traced_call):
    root = traced_call.root
    steps = [(s.start, s.end) for s in traced_call.spans
             if "." in s.name and s.thread == root.thread]
    share = union_s(steps) / root.seconds
    print(f"main-thread steps cover {100 * share:.1f} % of the call")
    assert share >= 0.95


def test_counters_equal_what_the_call_did(world, traced_call):
    c = traced_call.root.attrs
    assert c["pairs_parsed"] == len(world.reads)
    recruited = traced_call.recruited
    assert c["pairs_recruited"] == len({n for name in LOCI
                                        for n in recruited[name][1]})
    assert c["pairs_recruited"] == sum(len(recruited[name][1])
                                       for name in LOCI)
    n_haps = [len(world.loci[i].haplotypes) for i in range(len(LOCI))]
    assert c["genotypes_stage0"] == sum(h * (h + 1) // 2 for h in n_haps)
    assert c["k1_jobs"] == sum(traced_call.k1_rows) > 0
    # One upload of each group's job table, a fraction of the job arrays.
    assert c["k1_staged_bytes"] == sum(traced_call.k1_staged) > 0
    assert c["k1_staged_bytes"] < sum(traced_call.k1_assembled) / 2
    stages = [s for s in traced_call.spans if s.name.startswith("solve.st")]
    for s in stages:
        assert c[f"genotypes_{s.name[6:]}"] == s.attrs["genotypes"]
    # One annealer call a chunk; attempts: 1 greedy, 4 annealing (LIGHT).
    assert len(traced_call.chains) == sum(s.attrs["chunks"] for s in stages)
    attempts = {"solve.stage1": 1, "solve.stage2": 4}
    assert c["k2_chains"] == sum(traced_call.chains) == sum(
        s.attrs["genotypes"] * attempts[s.name] for s in stages)
    # The plain versions are no kernel launches; both mates of every pair
    # pass the minimizer front end.
    assert c["k1_launches"] == c["k2_launches"] == c["k3_launches"] == 0
    assert c["k3_rows"] == 2 * c["pairs_parsed"]


# --- recruitment entries against the host oracle ----------------------------

def load_loci(world):
    return {name: TG.load_locus(world.db, name) for name in LOCI}


def assert_same_recruits(a, b, ordered=True):
    for name in a:
        (pa, na), (pb, nb) = a[name], b[name]
        if not ordered:
            ia, ib = np.argsort(na, kind="stable"), np.argsort(nb,
                                                               kind="stable")
            pa, na = [pa[i] for i in ia], [na[i] for i in ia]
            pb, nb = [pb[i] for i in ib], [nb[i] for i in ib]
        assert na == nb, name
        for (a1, a2), (b1, b2) in zip(pa, pb):
            np.testing.assert_array_equal(a1, b1)
            assert (a2 is None) == (b2 is None)
            if a2 is not None:
                np.testing.assert_array_equal(a2, b2)


PAD = 9     # minimizer_w - 1: what a device row's padding adds to a read


#: Cases of the two recruitment entries on the same pairs: the fixture that
#: holds them, `recruit_reads_fast`'s options, the block size of both.
ENTRY_CASES = {
    "plain": ("world", {}, 4096),
    "subsample": ("world", dict(subsample=0.5, seed=3), 4096),
    "300bp": ("world300", {}, 64),
    # A too-small starting width restarts the FASTQ pass at the wider one.
    "300bp-restart": ("world300", dict(max_len=192), 64),
}


@pytest.mark.parametrize("case", list(ENTRY_CASES))
def test_recruit_entries_equal_the_host_oracle(request, case):
    """`recruit_reads_fast` (two FASTQ files, native parser, blocks) and
    `recruit_records` (the same pairs record by record) give identical
    per-locus lists, order included.  Without subsampling both equal
    `pipeline.recruit_reads`, the per-read host engine, on reads padded as
    a device row pads them; the padding moves one pair of 3,574 in the
    two-locus world (in the reference package too): a window at the read's
    end runs into the N codes behind it.  Both entries draw a subsample
    one number a pair in input order, so they keep the same pairs; the
    draw is reproducible and keeps roughly the asked share.  No read is
    ever clipped: the restart recruits what the right width does."""
    fixture, kw, batch = ENTRY_CASES[case]
    w = request.getfixturevalue(fixture)
    loci = load_loci(w) if fixture == "world" else w.loci
    rp = RecruitParams(match_frac=0.6)
    stats = {}
    fast, speed = TG.recruit_reads_fast(loci, w.r1, w.r2, rp, batch=batch,
                                        stats=stats, device="cpu", **kw)
    assert speed > 0 and stats["records"] == len(w.reads)
    per_record, _ = tpipeline.recruit_records(
        loci, iter(w.reads), rp, batch=batch, device="cpu",
        **{k: v for k, v in kw.items() if k != "max_len"})
    assert_same_recruits(per_record, fast)
    oracle = tpipeline.recruit_reads(loci, iter(w.reads), rp, pad=PAD)
    if "subsample" not in kw:
        assert_same_recruits(fast, oracle)
        assert all(len(names) > 10 for _, names in oracle.values())
    else:
        again, _ = TG.recruit_reads_fast(loci, w.r1, w.r2, rp, batch=batch,
                                         device="cpu", **kw)
        assert_same_recruits(again, fast)
        share = len(fast["GENE1"][1]) / len(oracle["GENE1"][1])
        assert 0.35 < share < 0.65
        assert set(fast["GENE1"][1]) <= set(oracle["GENE1"][1])
    if case == "plain":
        assert all(len(oracle[n][1]) > 300 for n in LOCI)
        unpadded = tpipeline.recruit_reads(loci, iter(w.reads), rp)
        for n in LOCI:
            assert len(set(unpadded[n][1]) ^ set(oracle[n][1])) <= 2


def test_single_and_mixed_reads_equal_the_host_oracle(world):
    """Short single reads go through device batches of their own; pairs of
    mates over 500 bases, mixed into the stream, stay on the host engine,
    which sees them unpadded; flushes of uneven sizes."""
    loci = load_loci(world)
    rp = RecruitParams(match_frac=0.6)
    reads = [(n, a, None) for n, a, _ in world.reads[:1800]]
    reads += world.reads[1800:]
    hap = loci["GENE1"].contig_set.seqs[0]
    long_pairs = [(f"long{i}", hap[s:s + 600].copy(),
                   dna.revcomp(hap[s + 300:s + 900]))
                  for i, s in enumerate(range(0, 3000, 150))]
    mixed = list(reads)
    for i, rec in enumerate(long_pairs):
        mixed.insert(150 * i + 7, rec)
    oracle = tpipeline.recruit_reads(loci, iter(reads), rp, pad=PAD)
    host = tpipeline.recruit_reads(loci, iter(long_pairs), rp)
    for name in LOCI:
        for want, extra in zip(oracle[name], host[name]):
            want += extra
    got, _ = tpipeline.recruit_records(loci, iter(mixed), rp, batch=700,
                                       device="cpu")
    assert_same_recruits(got, oracle, ordered=False)
    assert any(p[1] is None for p in got["GENE1"][0])
    assert any(p[1] is not None for p in got["GENE1"][0])
    assert sum(n.startswith("long") for n in got["GENE1"][1]) > 10


@pytest.fixture(scope="module")
def world300(tmp_path_factory):
    """One locus and a 300 bp paired sample (tests/test_readwidth.py)."""
    from locityper_tpu_torch.seq.contigs import ContigSet
    from locityper_tpu_torch.seq.counts import (GenomeKmerCounter,
                                                off_target_counts)
    root = tmp_path_factory.mktemp("w300")
    rng = np.random.default_rng(77)
    locus = sim.simulate_locus(rng, "G", length=4000, n_haps=4,
                               divergence=0.02)
    genome = np.concatenate([sim.random_genome(rng, 30_000),
                             locus.haplotypes[0],
                             sim.random_genome(rng, 30_000)])
    counter = GenomeKmerCounter(25)
    counter.add_seq(genome)
    counter.finalize()
    kc = off_target_counts(counter, locus.haplotypes, locus.haplotypes[0])
    cset = ContigSet("G", locus.hap_names, locus.haplotypes)
    true_haps = [locus.haplotypes[i] for i in locus.true_genotype]
    loc = sim.simulate_paired_reads(rng, true_haps, depth=6, read_len=300,
                                    insert_mean=700, insert_sd=60,
                                    prefix="loc")
    bg = sim.simulate_paired_reads(rng, [genome[:20_000]], depth=1,
                                   read_len=300, insert_mean=700,
                                   insert_sd=60, prefix="bg")
    reads = list(zip(loc.names + bg.names, loc.reads1 + bg.reads1,
                     loc.reads2 + bg.reads2))
    r1, r2 = root / "r_1.fq.gz", root / "r_2.fq.gz"
    with smart_create(r1) as f1, smart_create(r2) as f2:
        for n, a, b in reads:
            fastx.write_fastq(f1, fastx.Read(n, a))
            fastx.write_fastq(f2, fastx.Read(n, b))
    loci = {"G": SimpleNamespace(contig_set=cset, kmer_counts=kc)}
    return SimpleNamespace(loci=loci, r1=r1, r2=r2, reads=reads)


# --- the HiFi flow ------------------------------------------------------------

def test_hifi_flow_equals_reference(tmp_path):
    """tests/test_cli_longread.py through both command lines: long single
    reads are recruited in long device batches and aligned at band 160."""
    root = tmp_path
    rng = np.random.default_rng(42)
    locus = sim.simulate_locus(rng, "LRG", length=6000, n_haps=4,
                               divergence=0.012)
    left = sim.random_genome(rng, 50_000)
    right = sim.random_genome(rng, 50_000)
    genome = np.concatenate([left, locus.haplotypes[0], right])
    with open(root / "ref.fa", "w") as f:
        fastx.write_fasta(f, "chr1", genome)
    (root / "loci.bed").write_text(
        f"chr1\t{left.size}\t{left.size + locus.haplotypes[0].size}\tLRG\n")
    with open(root / "haps_LRG.fa", "w") as f:
        for name, seq in zip(locus.hap_names, locus.haplotypes):
            fastx.write_fasta(f, name, seq)
    err = sim.ErrorModel(mismatch=0.003, insertion=0.002, deletion=0.002)
    true_haps = [locus.haplotypes[i] for i in locus.true_genotype]
    locus_reads = sim.simulate_single_reads(
        rng, true_haps, depth=10.0, read_len_mean=2500, read_len_sd=300,
        errors=err, prefix="loc")
    bg_reads = sim.simulate_single_reads(
        rng, [left, right], depth=4.0, read_len_mean=2500, read_len_sd=300,
        errors=err, prefix="bg")
    with smart_create(root / "reads.fq.gz") as f:
        for nm, r in zip(locus_reads.names + bg_reads.names,
                         locus_reads.reads1 + bg_reads.reads1):
            fastx.write_fastq(f, fastx.Read(nm, r))
    assert jcli.main(["add", "-d", str(root / "db"), "-r",
                      str(root / "ref.fa"), "-l", str(root / "loci.bed"),
                      "-s", str(root / "haps_{}.fa")]) == 0
    assert jcli.main(["preproc", "-i", str(root / "reads.fq.gz"),
                      "-r", str(root / "ref.fa"), "-o", str(root / "sample"),
                      "--tech", "hifi", "-b", "chr1:2000-100000",
                      "--max-reads", "2000"]) == 0
    args = ["-i", str(root / "reads.fq.gz"), "-d", str(root / "db"),
            "-p", str(root / "sample"), "-S", "greedy:i=5k,a=1",
            "anneal:i=4,a=4,n=1500,p=800", "--seed", "7"]
    assert jcli.main(["genotype", *args, "-o", str(root / "j_out"),
                      "--stop-after", "recruit"]) == 0
    assert torch_cli("genotype", *args, "-o", root / "t_out",
                     "--stop-after", "recruit") == 0
    j_recs = fastq_records(root / "j_out" / "loci" / "LRG" / "reads.fq.gz")
    t_recs = fastq_records(root / "t_out" / "loci" / "LRG" / "reads.fq.gz")
    # Long batches are flushed by length class, so compare as sorted lists.
    assert sorted(t_recs) == sorted(j_recs) and len(t_recs) > 20
    assert all(n.startswith("loc") for n, _ in t_recs)
    assert torch_cli("genotype", *args, "-o", root / "t_out") == 0
    res = read_json(root / "t_out" / "loci" / "LRG" / "res.json.gz")
    truth = sorted(locus.hap_names[i] for i in locus.true_genotype)
    assert sorted(res["genotype"].split(",")) == truth, res


# --- the other subcommands ----------------------------------------------------

def text_of(path):
    raw = open(path, "rb").read()
    return gzip.decompress(raw) if raw[:2] == b"\x1f\x8b" else raw


def test_recruit_subcommand_equals_reference(world, tmp_path):
    j_out, t_out = tmp_path / "j.fq", tmp_path / "t.fq"
    args = ["-i", str(world.r1), str(world.r2), "-s",
            str(world.root / "haps_GENE1.fa"),
            str(world.root / "haps_GENE2.fa"), "-x", "illumina"]
    assert jcli.main(["recruit", *args, "-o", str(j_out)]) == 0
    assert torch_cli("recruit", *args, "-o", t_out) == 0
    assert text_of(t_out) == text_of(j_out)
    assert len(fastq_records(t_out)) > 1000
    assert torch_cli("recruit", "-i", "x", "-s", "y", "-o", "z", "-x",
                     "bogus") == 1


def test_align_and_paf_vcf_subcommands_equal_reference(world, tmp_path):
    haps = str(world.root / "haps_GENE1.fa")
    j_paf, t_paf = tmp_path / "j.paf", tmp_path / "t.paf"
    assert jcli.main(["align", "-i", haps, "-o", str(j_paf),
                      "--max-div", "1.0"]) == 0
    assert torch_cli("align", "-i", haps, "-o", t_paf, "--max-div",
                     "1.0") == 0
    assert text_of(t_paf) == text_of(j_paf)
    assert len(text_of(t_paf).splitlines()) == 10
    j_vcf, t_vcf = tmp_path / "j.vcf", tmp_path / "t.vcf"
    assert jcli.main(["paf-vcf", "-i", str(j_paf), "-q", haps, "-t", haps,
                      "-o", str(j_vcf)]) == 0
    assert torch_cli("paf-vcf", "-i", t_paf, "-q", haps, "-t", haps,
                     "-o", t_vcf) == 0
    assert text_of(t_vcf) == text_of(j_vcf)
    assert sum(not l.startswith(b"#")
               for l in text_of(t_vcf).splitlines()) > 100


def test_prune_and_add_subcommands_equal_reference(world, tmp_path):
    j_db, t_db = tmp_path / "j_db", tmp_path / "t_db"
    shutil.copytree(world.db, j_db)
    shutil.copytree(world.db, t_db)
    assert jcli.main(["prune", "-d", str(j_db), "-n", "2"]) == 0
    assert torch_cli("prune", "-d", t_db, "-n", "2") == 0
    for name in LOCI:
        a = text_of(t_db / "loci" / name / "haplotypes.fa.gz")
        assert a == text_of(j_db / "loci" / name / "haplotypes.fa.gz")
        assert a.count(b">") == 2
    # `add` writes the same database as the reference package's.
    t_add = tmp_path / "t_add"
    assert torch_cli("add", "-d", t_add, "-r", world.root / "ref.fa", "-l",
                     world.root / "loci.bed", "-s",
                     world.root / "haps_{}.fa") == 0
    for name in LOCI:
        for fn in ("haplotypes.fa.gz", "ref.bed"):
            assert text_of(t_add / "loci" / name / fn) == \
                text_of(world.db / "loci" / name / fn), (name, fn)
        a = np.load(t_add / "loci" / name / "kmers.npz")
        b = np.load(world.db / "loci" / name / "kmers.npz")
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(
            np.load(t_add / "loci" / name / "distances.npz")["div"],
            np.load(world.db / "loci" / name / "distances.npz")["div"])


def test_index_subcommand_and_bam_input(world, tmp_path):
    """`index` writes the same .bai; a BAM of the sample's first pairs goes
    through `genotype`'s per-record entry (`recruit_records`)."""
    reads = world.reads[:3000]
    for path in (tmp_path / "j.bam", tmp_path / "t.bam"):
        with jbam.BamWriter(path, ["chr1"], [300_000]) as w:
            for i, (name, c1, c2) in enumerate(reads):
                w.write(name, jbam.FLAG_PAIRED | jbam.FLAG_MATE1, c1,
                        ref_id=0, pos=10 * i)
                w.write(name, jbam.FLAG_PAIRED | jbam.FLAG_MATE2, c2,
                        ref_id=0, pos=10 * i + 5)
    assert jcli.main(["index", str(tmp_path / "j.bam")]) == 0
    assert torch_cli("index", tmp_path / "t.bam") == 0
    assert open(tmp_path / "t.bam.bai", "rb").read() == \
        open(tmp_path / "j.bam.bai", "rb").read()
    (tmp_path / "t.bam.bai").unlink()           # full scan, not the index
    out = tmp_path / "out"
    assert torch_cli("genotype", "-i", tmp_path / "t.bam", "-d", world.db,
                     "-p", world.prep, "-o", out, "--stop-after",
                     "recruit") == 0
    loci = load_loci(world)
    rp = RecruitParams(match_frac=0.5)      # the CLI's default for pairs
    oracle = tpipeline.recruit_reads(loci, iter(reads), rp, pad=PAD)
    for name in LOCI:
        pairs, names = TG._load_recruited(out / "loci" / name)
        assert names == oracle[name][1] and len(names) > 20
