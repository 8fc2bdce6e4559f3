"""The sample as users hold it: a coordinate-sorted, indexed CRAM or BAM
with its reference, through the port's `index`, `genotype -i x.cram -r
ref.fa` and `preproc -a x.cram -r ref.fa`, against the JAX package's on
the CPU.

The world of tests/test_torch_genotype_cmd.py, its pairs written as an
aligner would leave them: each mate at its place on chr1 (a locus pair at
its locus's start plus the fragment's offset in the haplotype it was drawn
from, a background pair at its own position), the reverse-strand mate in
reference orientation with flag 0x10, records sorted by their own position;
one in ten locus pairs unmapped (flag 0x4, no position) at the end, as an
aligner leaves reads of a divergent allele.  `genotype` then fetches the
padded locus regions and the unplaced tail through the index
(genotype.rs:792-870) in both packages; `preproc` fetches its background
region.  The port runs with `--device cpu` (the plain PyTorch versions of
the kernels).

Recruitment and `preproc`'s counts are integers: reads are compared name by
name, `distr.json.gz` as tests/test_torch_preproc.py compares it.  The two
annealers draw different random numbers, so calls are compared for
equality and likelihoods within tests/test_torch_pipeline.py's tolerance.
"""
import gzip
import json
import logging
import shutil
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from numpy.lib.stride_tricks import sliding_window_view

from locityper_tpu import cli as jcli
from locityper_tpu_torch.seq import bam as tbam
from locityper_tpu_torch.seq import dna
from locityper_tpu_torch.seq import fastx
from locityper_tpu_torch.seq.cram import CramWriter

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_cli_options import assert_same_top  # noqa: E402
from test_torch_genotype_cmd import (LOCI, SCHEME, fastq_records,  # noqa: E402
                                     read_json, torch_cli, world)
from test_torch_preproc import assert_same_json  # noqa: E402

torch.set_num_threads(1)        # the suite runs several workers side by side

READ_LEN = 150
MAX_INSERT = 800                # sim.simulate_paired_reads: N(400, 60)
PAIRED = tbam.FLAG_PAIRED
MATE = (tbam.FLAG_MATE1, tbam.FLAG_MATE2)


def mismatches(read, seq, start):
    """Mismatches of `read` against seq[start:] (past its end: all)."""
    ref = seq[start:start + read.size]
    return int((read[:ref.size] != ref).sum()) + read.size - ref.size


def place_pair(seq, pos, mates):
    """(offset of mate 1, offset of mate 2, which mate is reverse) in the
    source sequence: the forward mate starts the fragment at `pos`, the
    reverse one, complemented, ends it; where, is searched for."""
    rev = int(mismatches(mates[1], seq, pos) < mismatches(mates[0], seq, pos))
    back = dna.revcomp(mates[rev])[:READ_LEN // 2]     # reads carry indels
    span = seq[pos:pos + MAX_INSERT]
    if span.size < back.size:
        end = pos
    else:
        windows = sliding_window_view(span, back.size)
        end = pos + int(np.argmin((windows != back[None, :]).sum(axis=1)))
    starts = [pos, pos]
    starts[rev] = end
    return starts[0], starts[1], rev


def alignment_records(world):
    """The world's pairs as records (name, flag, codes, pos): the placed
    ones sorted by position, then the unplaced ones.  Returns (records,
    names of the unplaced pairs)."""
    placed, unplaced, n_locus = [], [], 0
    limit = world.genome.size - READ_LEN
    for name, c1, c2 in world.reads:
        seq, pos, start = world.frags[name]
        if not name.startswith("bg"):
            n_locus += 1
            if n_locus % 10 == 0:
                unplaced += [(name, PAIRED | MATE[i] | tbam.FLAG_UNMAPPED
                              | 0x8, c, -1) for i, c in enumerate((c1, c2))]
                continue
        p1, p2, rev = place_pair(seq, pos, (c1, c2))
        for i, (codes, p) in enumerate(((c1, p1), (c2, p2))):
            flag = PAIRED | MATE[i]
            if i == rev:
                flag |= tbam.FLAG_REVERSE
                codes = dna.revcomp(codes)      # reference orientation
            placed.append((name, flag, codes, min(start + p, limit)))
    placed.sort(key=lambda r: r[3])
    return placed + unplaced, {r[0] for r in unplaced}


@pytest.fixture(scope="module")
def files(world):
    """The records as a CRAM (against ref.fa) and a BAM, one copy of each
    for each package's `index`; the two packages' indexes must be equal."""
    records, unplaced = alignment_records(world)
    ref_fa = world.root / "ref.fa"
    root = world.root / "aln"
    root.mkdir()
    cram, bam = root / "j.cram", root / "j.bam"
    with CramWriter(cram, ["chr1"], [world.genome.size],
                    reference={"chr1": world.genome}) as w:
        for name, flag, codes, pos in records:
            w.write(name, flag, codes, ref_id=0 if pos >= 0 else -1, pos=pos)
    with tbam.BamWriter(bam, ["chr1"], [world.genome.size]) as w:
        for name, flag, codes, pos in records:
            w.write(name, flag, codes, ref_id=0 if pos >= 0 else -1, pos=pos)
    for path in (cram, bam):
        shutil.copy(path, root / ("t" + path.suffix))
        assert jcli.main(["index", str(path)]) == 0
        assert torch_cli("index", root / ("t" + path.suffix)) == 0
    # A .crai is gzip text whose header names the file: compare the text.
    assert gzip.decompress((root / "t.cram.crai").read_bytes()) == \
        gzip.decompress((root / "j.cram.crai").read_bytes())
    assert (root / "t.bam.bai").read_bytes() == \
        (root / "j.bam.bai").read_bytes()
    return SimpleNamespace(root=root, ref=ref_fa, unplaced=unplaced,
                           n_records=len(records))


def test_records_read_back_as_drawn(world, files):
    """The readers give back the drawn reads: the reverse-strand mates
    come back complemented, the unplaced pairs keep their bases."""
    drawn = {name: (c1, c2) for name, c1, c2 in world.reads}
    recs = list(tbam.read_bam_records(files.root / "t.bam"))
    assert len(recs) == files.n_records
    for r in recs:
        assert np.array_equal(r.seq, drawn[r.name][r.mate_ix]), r.name
    assert sum(bool(r.flag & tbam.FLAG_REVERSE) for r in recs) \
        == sum(not r.flag & tbam.FLAG_UNMAPPED for r in recs) // 2
    positions = [r.pos for r in recs if r.pos >= 0]
    assert positions == sorted(positions)


class IndexedLines(logging.Handler):
    """Collects the `Indexed input` messages of both packages' loggers
    ("locityper") while in use."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        if record.getMessage().startswith("Indexed input"):
            self.lines.append(record.getMessage())

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


def run_both(argv_of):
    """Runs `argv_of(side)` through the JAX package's command line ("j")
    and the port's ("t"); returns the `Indexed input` lines of each."""
    lines = []
    for side in "jt":
        with IndexedLines() as log:
            argv = argv_of(side)
            rc = jcli.main(argv) if side == "j" else torch_cli(*argv)
        assert rc == 0, side
        lines.append(log.lines)
    return lines


def genotype_argv(world, files, kind, out, *extra):
    """`genotype -i <kind> -r ref.fa` of one package: the JAX package on
    its copy and index, the port on its own."""
    return lambda side: [
        "genotype", "-i", str(files.root / f"{side}.{kind}"), "-r",
        str(files.ref), "-d", str(world.db), "-p", str(world.prep), "-o",
        str(out / side), *SCHEME, "--seed", "5", *extra]


@pytest.fixture(scope="module")
def cram_run(world, files, tmp_path_factory):
    out = tmp_path_factory.mktemp("cram_run")
    lines = run_both(genotype_argv(world, files, "cram", out,
                                   "--stop-after", "recruit"))
    recruited = {name: tuple(fastq_records(out / side / "loci" / name
                                           / "reads.fq.gz")
                             for side in "jt") for name in LOCI}
    # The full run resumes from the recruited reads.
    run_both(genotype_argv(world, files, "cram", out))
    return SimpleNamespace(out=out, lines=lines, recruited=recruited)


def test_cram_recruits_equal_reads_by_indexed_fetch(world, files, cram_run):
    j_lines, t_lines = cram_run.lines
    assert len(j_lines) == 1 and t_lines == j_lines, cram_run.lines
    assert "2 locus region(s) + unplaced tail" in t_lines[0]
    for name in LOCI:
        j_recs, t_recs = cram_run.recruited[name]
        assert t_recs == j_recs, name
        names = {n.rpartition("/")[0] or n for n, _ in t_recs}
        assert sum(n.startswith(name) for n in names) > 300, name
        # Pairs the aligner left unplaced come in through the tail.
        assert len(names & files.unplaced) > 10, name


def test_cram_full_run_calls_equal(world, cram_run):
    for name in LOCI:
        j_res, t_res = (read_json(cram_run.out / side / "loci" / name
                                  / "res.json.gz") for side in "jt")
        assert_same_top(name, j_res, t_res, world.truth[name])


def test_bam_twin_recruits_what_the_cram_does(world, files, cram_run,
                                              tmp_path):
    with IndexedLines() as log:
        assert torch_cli("genotype", "-i", files.root / "t.bam", "-r",
                         files.ref, "-d", world.db, "-p", world.prep, "-o",
                         tmp_path, "--stop-after", "recruit") == 0
    assert len(log.lines) == 1, log.lines
    for name in LOCI:
        got = fastq_records(tmp_path / "loci" / name / "reads.fq.gz")
        assert got == cram_run.recruited[name][1], name


def test_preproc_from_indexed_cram_equal(world, files, tmp_path):
    """`preproc -a x.cram -r ref.fa`: the background region is fetched
    through the .crai (preproc.rs:1180-1202); every count of
    distr.json.gz equal to the JAX package's."""
    lines = run_both(lambda side: [
        "preproc", "-a", str(files.root / f"{side}.cram"), "-r",
        str(files.ref), "-o", str(tmp_path / side), "-b",
        "chr1:10000-110000", "--max-reads", "8000"])
    assert len(lines[0]) == 1 and lines[1] == lines[0], lines
    got = []
    for side in "jt":
        with gzip.open(tmp_path / side / "bg" / "distr.json.gz", "rt") as f:
            got.append(json.load(f))
    assert_same_json(got[0], got[1])
    assert got[1]["seq_info"]["total_reads"] is None
    ins = got[1]["insert_distr"]
    assert np.isfinite(ins["n"]) and np.isfinite(ins["p"])
