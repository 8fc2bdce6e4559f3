"""`preproc` of long and single-end reads, and `genotype` of long reads from
FASTQ and from an indexed BAM, in the port against the JAX package, on the
same files.

The world: one contig of 106 kb, a locus of 6,000 bp (4 haplotypes at 1.2 %
divergence) between random flanks of 50 kb; the sample is two copies of the
contig, each with one haplotype of the truth in the locus's place.  Reads
are drawn along both copies: ONT-like (2,500 +- 300 bases, 2 % / 0.8 % /
0.8 % errors, 5x a copy), HiFi-like (the same lengths, 0.06 % / 0.02 % /
0.02 %, 4x), single-end Illumina (150 bp, 0.2 % / 0.02 % / 0.02 %, 10x)
and PacBio-like (3x; CLR-like 3 % / 6 % / 3 % errors and a quarter of
them).  Both packages' `preproc` run on each read set with `-b
chr1:2000-48000 --max-reads 2000`; the port runs with `--device cpu` (the
plain PyTorch versions of the kernels).

What the estimation counts is compared exactly (the error-op counts, the
(edit, length) triples, the depth counts per window with their GC; no
insert sizes without pairs), every float of `distr.json.gz` within a
relative 1e-9, as tests/test_torch_preproc.py compares them.

The ONT reads are also written as an aligner leaves them (each read at its
place on the contig with CIGAR `<len>M`, a read of the reverse strand with
flag 0x10 and its bases in contig orientation, sorted by position) to a BAM
that both packages' `index` index, and go through `preproc -a` and
`genotype -i`.  Last, ONT reads over BASELINE config 3's locus (a gene and
its paralog at 97 % identity downstream) go through `genotype` of both
packages on the port's own `preproc` output.  Long batches flush by length
class, so recruited reads are compared as sorted lists; the two annealers
draw different random numbers, so calls are compared for equality and
likelihoods within tests/test_torch_pipeline.py's tolerance.
"""
import gzip
import logging
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from locityper_tpu import bg as jbg
from locityper_tpu import cli as jcli
from locityper_tpu import pipeline as jpipeline
from locityper_tpu import sim
from locityper_tpu.bg import depth as jdepth
from locityper_tpu.bg import err_prof as jerr
from locityper_tpu.bg import insertsz as jins
from locityper_tpu.commands import preproc as JP
from locityper_tpu.seq.counts import GenomeKmerCounter as JCounter
from locityper_tpu_torch import bg as tbg
from locityper_tpu_torch import pipeline as tpipeline
from locityper_tpu_torch.bg import depth as tdepth
from locityper_tpu_torch.bg import err_prof as terr
from locityper_tpu_torch.bg import insertsz as tins
from locityper_tpu_torch.commands import preproc as TP
from locityper_tpu_torch.seq import bam as tbam
from locityper_tpu_torch.seq import dna, fastx
from locityper_tpu_torch.seq.counts import GenomeKmerCounter

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_cli_options import assert_same_top  # noqa: E402
from test_torch_genotype_cmd import (fastq_records, read_json,  # noqa: E402
                                     torch_cli)
from test_torch_preproc import (Capture, _best_per_mate,  # noqa: E402
                                _rule, assert_same_json, read_distr)

torch.set_num_threads(1)        # the suite runs several workers side by side

FLANK = 50_000
LOCUS_LEN = 6_000
BG = ["-b", "chr1:2000-48000", "--max-reads", "2000"]
SCHEME = ["-S", "greedy:i=5k,a=1", "anneal:i=8,a=8,n=3000,p=2000"]
LONG = (2_500, 300)             # read length: mean, sd
ONT = sim.ErrorModel(0.02, 0.008, 0.008)
HIFI = sim.ErrorModel(0.0006, 0.0002, 0.0002)
ILLUMINA = sim.ErrorModel(0.002, 0.0002, 0.0002)
CLR = sim.ErrorModel(0.03, 0.06, 0.03)
# A PacBio error rate at which the JAX package's `preproc` does recruit to
# the background region: a quarter of CLR's rates.  On this world at 3x a
# copy it recruits 0 of 256 reads at CLR's rates, 9 of 256 at half of them
# and 238 of 255 at a quarter.
PACBIO_OK = sim.ErrorModel(0.0075, 0.015, 0.0075)
FIELDS = ("start", "end", "fwd", "n_mism", "n_ins", "n_del", "n_clip",
          "edit", "ln_prob")


def with_errors(rng, frag, err):
    """`sim.ErrorModel.apply`'s per-base events, drawn for all bases at
    once: deletion, insertion before the base, mismatch or match."""
    r = rng.random(frag.size)
    d, i = err.deletion, err.deletion + err.insertion
    out = frag.copy()
    mism = (r >= i) & (r < i + err.mismatch)
    out[mism] = (out[mism] + rng.integers(1, 4, int(mism.sum()))) % 4
    keep = r >= d
    ins = ((r >= d) & (r < i))[keep]
    return np.insert(out[keep], np.flatnonzero(ins),
                     rng.integers(0, 4, int(ins.sum())).astype(np.int8))


def draw_reads(rng, copies, depth, err, prefix, length=LONG, fixed=False):
    """Single reads along each sequence of `copies` at `depth` a copy, as
    `sim.simulate_single_reads` draws them (a read of the reverse strand in
    half the draws), with `fixed` lengths (Illumina) or N(mean, sd).
    Returns (names, reads, places): places[i] = (copy, start, span, rev)."""
    names, reads, places = [], [], []
    for c, seq in enumerate(copies):
        covered = 0
        while covered < depth * seq.size:
            span = length[0] if fixed else min(
                max(int(rng.normal(*length)), 300), seq.size)
            start = int(rng.integers(0, seq.size - span + 1))
            frag = seq[start:start + span]
            rev = bool(rng.random() < 0.5)
            if rev:
                frag = dna.revcomp(frag)
            reads.append(with_errors(rng, frag, err))
            names.append(f"{prefix}{len(names):06d}")
            places.append((c, start, span, rev))
            covered += span
    return names, reads, places


def write_fq(path, names, reads):
    with gzip.open(path, "wt", compresslevel=1) as f:
        for name, seq in zip(names, reads):
            fastx.write_fastq(f, fastx.Read(name, seq))


def single_counts(cap):
    """What a single-end estimation counted: no insert sizes."""
    assert "insert" not in cap.calls
    n_match, n_mism, n_ins, n_del, triples = cap.calls["errors"][0]
    (depth1, gc), kw = cap.calls["depth"][0][:2], cap.calls["depth"][1]
    return dict(ops=(n_match, n_mism, n_ins, n_del), triples=sorted(triples),
                depth=np.asarray(depth1).tolist(),
                gc=np.asarray(gc).tolist(),
                subsampling_rate=kw["subsampling_rate"])


class Messages(logging.Handler):
    """The messages of both packages' loggers ("locityper") while in use."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append((record.levelno, record.getMessage()))

    def __enter__(self):
        log = logging.getLogger("locityper")
        self._level = log.level
        log.setLevel(logging.INFO)
        log.addHandler(self)
        return self

    def __exit__(self, *exc):
        log = logging.getLogger("locityper")
        log.removeHandler(self)
        log.setLevel(self._level)

    def errors(self):
        return [m for level, m in self.lines if level >= logging.ERROR]

    def starting(self, prefix):
        return [m for _, m in self.lines if m.startswith(prefix)]


def cli_both(argv_of, expect=0):
    """`argv_of(side)` through the JAX package's command line ("j") and the
    port's ("t"); returns each side's messages."""
    logs = []
    for side in "jt":
        with Messages() as log:
            argv = argv_of(side)
            rc = jcli.main(argv) if side == "j" else torch_cli(*argv)
        assert rc == expect, (side, rc, log.errors())
        logs.append(log)
    return logs


def to_contig(places, hap_lens, start_of_locus, hap0_len):
    """Contig positions of reads drawn along copies that hold a haplotype
    of `hap_lens[copy]` bases where the contig holds one of `hap0_len`: a
    read that starts in the locus starts at the locus's start plus its
    offset in the haplotype (cut at the locus's end); past the locus, at
    its place shifted by the difference in length."""
    out = []
    for c, start, _span, _rev in places:
        if start < start_of_locus:
            out.append(start)
        elif start < start_of_locus + hap_lens[c]:
            out.append(start_of_locus + min(start - start_of_locus,
                                            hap0_len - 1))
        else:
            out.append(start - hap_lens[c] + hap0_len)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The contig, the locus, its database (the JAX package's `add`) and
    the read sets, written to gzip FASTQ."""
    root = tmp_path_factory.mktemp("longread")
    rng = np.random.default_rng(42)
    locus = sim.simulate_locus(rng, "LRG", length=LOCUS_LEN, n_haps=4,
                               divergence=0.012)
    left, right = sim.random_genome(rng, FLANK), sim.random_genome(rng, FLANK)
    genome = np.concatenate([left, locus.haplotypes[0], right])
    copies = [np.concatenate([left, locus.haplotypes[h], right])
              for h in locus.true_genotype]
    with open(root / "ref.fa", "w") as f:
        fastx.write_fasta(f, "chr1", genome)
    (root / "loci.bed").write_text(
        f"chr1\t{FLANK}\t{FLANK + locus.haplotypes[0].size}\tLRG\n")
    with open(root / "haps_LRG.fa", "w") as f:
        for name, seq in zip(locus.hap_names, locus.haplotypes):
            fastx.write_fasta(f, name, seq)
    sets = {}
    for tech, depth, err, kw in (
            ("ont", 5.0, ONT, {}), ("hifi", 4.0, HIFI, {}),
            ("illumina", 10.0, ILLUMINA, dict(length=(150, 0), fixed=True)),
            ("clr", 3.0, CLR, {}), ("pacbio", 3.0, PACBIO_OK, {})):
        names, reads, places = draw_reads(rng, copies, depth, err, tech[:3],
                                          **kw)
        fq = root / f"{tech}.fq.gz"
        write_fq(fq, names, reads)
        sets[tech] = SimpleNamespace(names=names, reads=reads, places=places,
                                     fq=fq)
    assert jcli.main(["add", "-d", str(root / "db"), "-r",
                      str(root / "ref.fa"), "-l", str(root / "loci.bed"),
                      "-s", str(root / "haps_{}.fa")]) == 0
    return SimpleNamespace(root=root, ref=root / "ref.fa", db=root / "db",
                           genome=genome, locus=locus, sets=sets,
                           truth=sorted(locus.hap_names[i]
                                        for i in locus.true_genotype))


def preproc_argv(world, inputs, tech, out_name):
    return lambda side: ["preproc", *map(str, inputs), "-r", str(world.ref),
                         "-o", str(world.root / f"{side}_{out_name}"),
                         "--tech", tech, *BG]


# --- preproc for each technology --------------------------------------------

@pytest.fixture(scope="module")
def tech_runs(world):
    """Both packages' `preproc` once for each read set, recording what each
    estimation counted."""
    runs = {}

    def run(key, tech):
        if key not in runs:
            with pytest.MonkeyPatch.context() as mp:
                j_cap = Capture(mp, jins, jerr, jdepth)
                t_cap = Capture(mp, tins, terr, tdepth)
                cli_both(preproc_argv(world, ["-i", world.sets[key].fq],
                                      tech, key))
            runs[key] = SimpleNamespace(
                j_json=read_distr(world.root / f"j_{key}"),
                t_json=read_distr(world.root / f"t_{key}"),
                j_counts=single_counts(j_cap), t_counts=single_counts(t_cap))
        return runs[key]
    return run


@pytest.mark.parametrize("key, tech", [("ont", "ont"), ("hifi", "hifi"),
                                       ("illumina", "illumina")])
def test_preproc_equals_jax(world, tech_runs, key, tech):
    """`distr.json.gz` equal (integers and strings exactly, floats within
    FLOAT_REL), every count exact, `total_reads` the records of the input."""
    r = tech_runs(key, tech)
    assert_same_json(r.j_json, r.t_json)
    assert r.t_counts == r.j_counts
    info = r.t_json["seq_info"]
    assert info["total_reads"] == len(world.sets[key].names)
    assert info["technology"] == tbg.Technology.parse(tech).value
    assert r.t_counts["ops"][0] > 100_000


def test_pacbio_clr_fails_alike(world):
    """At CLR-like errors (3 % / 6 % / 3 %) neither package recruits a read
    to the background region: the same exit code and the same message.
    This is the JAX package's own semantics, kept by the port."""
    logs = cli_both(preproc_argv(world, ["-i", world.sets["clr"].fq],
                                 "pacbio", "clr"), expect=1)
    j_err, t_err = (log.errors() for log in logs)
    assert t_err == j_err and len(t_err) == 1
    assert t_err[0].startswith("No reads recruited to the background region")


def test_pacbio_equals_jax(world, tech_runs):
    """At 0.75 % / 1.5 % / 0.75 %, a quarter of CLR's rates, the JAX
    package recruits to the background region (PACBIO_OK), and both
    packages write the same `distr.json.gz` from the same counts."""
    r = tech_runs("pacbio", "pacbio")
    assert_same_json(r.j_json, r.t_json)
    assert r.t_counts == r.j_counts
    assert r.t_json["seq_info"]["technology"] == "pacbio"
    assert r.t_json["seq_info"]["total_reads"] == \
        len(world.sets["pacbio"].names)


# --- the estimation at the function -----------------------------------------

@pytest.fixture(scope="module")
def ont_region(world):
    """The first 120 ONT reads drawn inside `preproc`'s padded region, the
    region, and each package's k-mer counts of the contig."""
    s = world.sets["ont"]
    lo, hi = 0, 98_000          # chr1:2000-48000 +- preproc's BG_PADDING
    ix = [i for i, (_, start, span, _) in enumerate(s.places)
          if lo <= start and start + span <= hi][:120]
    counters = JCounter(25), GenomeKmerCounter(25)
    for c in counters:
        c.add_seq(world.genome)
        c.finalize()
    return SimpleNamespace(names=[s.names[i] for i in ix],
                           reads=[s.reads[i] for i in ix],
                           region=world.genome[lo:hi], counters=counters)


def test_best_alignment_of_every_ont_read_equal(ont_region):
    """The estimation's best alignment of every read, field by field.  A
    read moved by the aligners' rules (ROADMAP Queue C item 8) would be
    named by `_rule`; none is allowed here."""
    r = ont_region
    j_best = _best_per_mate("locityper_tpu", r.reads, r.region, {})
    t_best = _best_per_mate("locityper_tpu_torch", r.reads, r.region,
                            {"device": "cpu"})
    moved = []
    for m, (j, t) in enumerate(zip(j_best, t_best)):
        jv = None if j is None else tuple(getattr(j, f) for f in FIELDS)
        tv = None if t is None else tuple(getattr(t, f) for f in FIELDS)
        if jv != tv:
            moved.append(f"{r.names[m]}: JAX {jv}, port {tv} — "
                         f"{_rule(j, t)}")
    assert not moved, f"{len(moved)} reads moved:\n" + "\n".join(moved[:20])
    assert sum(b is not None for b in t_best) > 0.95 * len(r.reads)


@pytest.mark.parametrize("min_mapq", [0, 30])
def test_estimate_bg_from_reads_on_ont_equals_jax(ont_region, monkeypatch,
                                                  min_mapq):
    """`estimate_bg_from_reads` with `reads2=[]`: every count exact and
    every float within FLOAT_REL, without the MAPQ filter and at `preproc`'s
    default of 30.  At 30 both packages drop a read whose two candidate
    windows give the same alignment (a gap of 0 to the second best), as
    most long reads' do: fewer reads count for the depth."""
    r = ont_region
    j_cap = Capture(monkeypatch, jins, jerr, jdepth)
    t_cap = Capture(monkeypatch, tins, terr, tdepth)
    kw = dict(subsampling_rate=0.5, edit_pval=0.01, max_clipping=0.02,
              min_mapq=min_mapq)
    j_bgd = jpipeline.estimate_bg_from_reads(
        r.reads, [], r.region, r.counters[0], jbg.Technology.NANOPORE,
        depth_params=jdepth.ReadDepthParams(), **kw)
    t_bgd = tpipeline.estimate_bg_from_reads(
        r.reads, [], r.region, r.counters[1], tbg.Technology.NANOPORE,
        depth_params=tdepth.ReadDepthParams(), device="cpu", **kw)
    counts = single_counts(t_cap)
    assert counts == single_counts(j_cap)
    assert_same_json(j_bgd.to_json(), t_bgd.to_json())
    assert not t_bgd.insert_distr.is_paired_end
    assert sum(counts["depth"]) > 0


# --- the ONT sample as an indexed BAM ---------------------------------------

@pytest.fixture(scope="module")
def ont_bam(world):
    """The ONT reads as an aligner leaves them, sorted, one copy for each
    package's `index`; the two indexes must be equal."""
    s, locus = world.sets["ont"], world.locus
    hap_lens = [locus.haplotypes[h].size for h in locus.true_genotype]
    pos = to_contig(s.places, hap_lens, FLANK,
                    locus.haplotypes[0].size)
    records = []
    for name, read, p, (_, _, _, rev) in zip(s.names, s.reads, pos,
                                             s.places):
        p = min(p, world.genome.size - read.size)
        flag = tbam.FLAG_REVERSE if rev else 0
        codes = dna.revcomp(read) if rev else read   # contig orientation
        records.append((p, name, flag, codes))
    records.sort(key=lambda r: r[0])
    paths = {}
    for side in "jt":
        paths[side] = world.root / f"{side}_ont.bam"
        with tbam.BamWriter(paths[side], ["chr1"],
                            [world.genome.size]) as w:
            for p, name, flag, codes in records:
                w.write(name, flag, codes, ref_id=0, pos=p,
                        cigar=[("M", int(codes.size))])
    assert jcli.main(["index", str(paths["j"])]) == 0
    assert torch_cli("index", paths["t"]) == 0
    return SimpleNamespace(paths=paths, records=records)


def test_bam_index_equal_and_reads_back(world, ont_bam):
    j_bai, t_bai = (Path(f"{ont_bam.paths[s]}.bai").read_bytes()
                    for s in "jt")
    assert t_bai == j_bai
    s = world.sets["ont"]
    drawn = dict(zip(s.names, s.reads))
    recs = list(tbam.read_bam_records(ont_bam.paths["t"]))
    assert len(recs) == len(s.names)
    assert not any(r.is_paired for r in recs)
    # `preproc`'s layout decision for a BAM input, in both packages.
    for pkg in (JP, TP):
        assert not pkg._input_is_paired(SimpleNamespace(
            input=[ont_bam.paths["t"]], interleaved=False))
    for r in recs:
        assert np.array_equal(r.seq, drawn[r.name]), r.name
    assert [r.pos for r in recs] == sorted(r.pos for r in recs)


@pytest.fixture(scope="module")
def bam_preproc(world, ont_bam):
    """`preproc -a ont.bam --tech ont` of both packages: the background
    region fetched through the .bai."""
    logs = cli_both(lambda side: [
        "preproc", "-a", str(ont_bam.paths[side]), "-r", str(world.ref),
        "-o", str(world.root / f"{side}_bam"), "--tech", "ont", *BG])
    return logs


def test_preproc_from_indexed_bam_equal(world, bam_preproc):
    fetched = [log.starting("Indexed input") for log in bam_preproc]
    assert len(fetched[0]) == 1 and fetched[1] == fetched[0], fetched
    j_json, t_json = (read_distr(world.root / f"{s}_bam") for s in "jt")
    assert_same_json(j_json, t_json)
    assert t_json["seq_info"]["total_reads"] is None
    assert t_json["seq_info"]["technology"] == tbg.Technology.NANOPORE.value
    assert t_json["insert_distr"] == j_json["insert_distr"]


@pytest.fixture(scope="module")
def bam_genotype(world, ont_bam, bam_preproc):
    """`genotype -i ont.bam` of both packages on their own `preproc -a`
    output: `--stop-after recruit`, then the full run from the reads."""
    out = world.root / "bam_out"

    def argv(*extra):
        return lambda side: [
            "genotype", "-i", str(ont_bam.paths[side]), "-d", str(world.db),
            "-p", str(world.root / f"{side}_bam"), "-o", str(out / side),
            *SCHEME, "--seed", "5", *extra]
    logs = cli_both(argv("--stop-after", "recruit"))
    recruited = [fastq_records(out / side / "loci" / "LRG" / "reads.fq.gz")
                 for side in "jt"]
    cli_both(argv())
    return SimpleNamespace(out=out, logs=logs, recruited=recruited)


def test_genotype_from_indexed_bam_equal(world, bam_genotype):
    fetched = [log.starting("Indexed input") for log in bam_genotype.logs]
    assert len(fetched[0]) == 1 and fetched[1] == fetched[0], fetched
    j_recs, t_recs = bam_genotype.recruited
    assert sorted(t_recs) == sorted(j_recs) and len(t_recs) > 10
    assert all(n.startswith("ont") for n, _ in t_recs)
    j_res, t_res = (read_json(bam_genotype.out / s / "loci" / "LRG"
                              / "res.json.gz") for s in "jt")
    assert_same_top("LRG", j_res, t_res, world.truth)


# --- long reads over a locus and its paralog --------------------------------

def widen(locus, left, right):
    """`locus` with `left` and `right` around each haplotype: a locus that
    can hold reads longer than the gene."""
    return sim.SimLocus(locus.name, [np.concatenate([left, h, right])
                                     for h in locus.haplotypes],
                        locus.hap_names, locus.true_genotype)


def test_ont_over_paralog_locus_equal(tmp_path):
    """BASELINE config 3's locus at a CPU's size: a gene of 5,000 bp in 2
    clades (2 haplotypes each, 2 % / 0.3 %), its paralog at 97 % identity
    2 kb downstream (10 kb on the card), flanks of 12 kb, under ONT reads of
    4,000 +- 300 bases, so that most reads over the locus span the gene,
    the spacer and the paralog.  Both packages take a read whose best
    alignment is clipped past the error profile's edit threshold as poorly
    mapped, so the locus is widened to hold such reads: the gene with 1.5
    kb of the left flank before it and the spacer, the paralog and 1.5 kb
    of the right flank after it (15 kb).  The port's `preproc --tech ont`
    output feeds both packages' `genotype`; the recruited reads and the
    calls are equal, and every read that spans gene and paralog is
    recruited."""
    rng = np.random.default_rng(7)
    gene = sim.simulate_structured_locus(
        rng, "CYP", length=5000, n_clades=2, haps_per_clade=2,
        clade_divergence=0.02, within_divergence=0.003)
    paralog = sim.make_paralog(rng, gene.haplotypes[0], identity=0.97)
    flanks = [sim.random_genome(rng, n) for n in (12_000, 2_000, 12_000)]
    margin = 1_500
    locus = widen(gene, flanks[0][-margin:],
                  np.concatenate([flanks[1], paralog, flanks[2][:margin]]))
    left, right = flanks[0][:-margin], flanks[2][margin:]
    genome = np.concatenate([left, locus.haplotypes[0], right])
    copies = [np.concatenate([left, locus.haplotypes[h], right])
              for h in locus.true_genotype]
    names, reads, places = draw_reads(rng, copies, 4.0, ONT, "ont",
                                      length=(4_000, 300))
    fq = tmp_path / "ont.fq.gz"
    write_fq(fq, names, reads)
    with open(tmp_path / "ref.fa", "w") as f:
        fastx.write_fasta(f, "chr1", genome)
    start = left.size
    (tmp_path / "loci.bed").write_text(
        f"chr1\t{start}\t{start + locus.haplotypes[0].size}\tCYP\n")
    with open(tmp_path / "haps_CYP.fa", "w") as f:
        for name, seq in zip(locus.hap_names, locus.haplotypes):
            fastx.write_fasta(f, name, seq)
    db, prep = tmp_path / "db", tmp_path / "sample"
    assert torch_cli("add", "-d", db, "-r", tmp_path / "ref.fa", "-l",
                     tmp_path / "loci.bed", "-s",
                     tmp_path / "haps_{}.fa") == 0
    assert torch_cli("preproc", "-i", fq, "-r", tmp_path / "ref.fa", "-o",
                     prep, "--tech", "ont", "-b", f"chr1:1000-{start}",
                     "--max-reads", "2000") == 0
    out = tmp_path / "out"

    def argv(*extra):
        return lambda side: ["genotype", "-i", str(fq), "-d", str(db), "-p",
                             str(prep), "-o", str(out / side), *SCHEME,
                             "--seed", "5", *extra]
    cli_both(argv("--stop-after", "recruit"))
    j_recs, t_recs = (fastq_records(out / s / "loci" / "CYP" / "reads.fq.gz")
                      for s in "jt")
    assert sorted(t_recs) == sorted(j_recs) and len(t_recs) > 20
    # Reads that cover 200 bases or more of the gene, the spacer and 200 or
    # more of the paralog (in the first copy's coordinates; the haplotypes'
    # lengths differ by a few bases).
    gene_end = start + margin + gene.haplotypes[0].size
    para_start = gene_end + flanks[1].size
    spanning = {n for n, (_, s0, span, _) in zip(names, places)
                if s0 < gene_end - 200 and s0 + span > para_start + 200}
    got = {n.rpartition("/")[0] or n for n, _ in t_recs}
    assert len(spanning) >= 3 and spanning <= got, (len(got), len(spanning))
    cli_both(argv())
    j_res, t_res = (read_json(out / s / "loci" / "CYP" / "res.json.gz")
                    for s in "jt")
    truth = sorted(locus.hap_names[i] for i in locus.true_genotype)
    assert_same_top("CYP", j_res, t_res, truth)
