"""The read inputs of the port's commands (seq/inputs.py): the one routing
rule that sends an input set to the two-file FASTQ block reader or to the
per-record path, held for each command on each input kind the port's tests
build; and the text reader closing the files it opens."""
import gc
import warnings
from types import SimpleNamespace

import numpy as np
import pytest

from locityper_tpu_torch import sim
from locityper_tpu_torch.commands import genotype as TG
from locityper_tpu_torch.seq import fastx, inputs
from locityper_tpu_torch.seq.counts import KmerCounts
from locityper_tpu_torch.utils import paths
from locityper_tpu_torch.utils.io import smart_create

#: How each command asks: `genotype` and `preproc` pass the background's
#: technology, `recruit` has none and caps the pairs at 500 bases.
COMMANDS = {
    "genotype": lambda kind: dict(interleaved=kind.interleaved,
                                  short_reads=kind.short),
    "preproc": lambda kind: dict(interleaved=kind.interleaved,
                                 short_reads=kind.short),
    "recruit": lambda kind: dict(interleaved=kind.interleaved,
                                 max_pair_len=500),
}

#: Input kind -> (files, --interleaved, short-read technology, the route
#: of genotype, preproc and recruit: "blocks" or "records").
KINDS = {
    "two gzip FASTQs": (["r1.fq.gz", "r2.fq.gz"], False, True,
                        ("blocks", "blocks", "blocks")),
    "pairs over 500 bp": (["l1.fq.gz", "l2.fq.gz"], False, True,
                          ("blocks", "blocks", "records")),
    "interleaved": (["inter.fq.gz"], True, True,
                    ("records", "records", "records")),
    "single-end": (["r1.fq.gz"], False, True,
                   ("records", "records", "records")),
    "long reads": (["ont.fq.gz"], False, False,
                   ("records", "records", "records")),
    "long reads, two files": (["l1.fq.gz", "l2.fq.gz"], False, False,
                              ("records", "records", "records")),
    "two FASTAs": (["r1.fa", "r2.fa"], False, True,
                   ("records", "records", "records")),
    "BAM": (["x.bam"], False, True, ("records", "records", "records")),
    "CRAM": (["x.cram"], False, True, ("records", "records", "records")),
    "indexed BAM": (["i.bam"], False, True,
                    ("records", "records", "records")),
    "indexed CRAM": (["i.cram"], False, True,
                     ("records", "records", "records")),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("inputs")
    rng = np.random.default_rng(0)

    def fastq(name, n, length):
        with smart_create(root / name) as f:
            for i in range(n):
                fastx.write_fastq(f, fastx.Read(
                    f"r{i}", sim.random_genome(rng, length)))

    for name, length in (("r1.fq.gz", 150), ("r2.fq.gz", 150),
                         ("inter.fq.gz", 150), ("l1.fq.gz", 600),
                         ("l2.fq.gz", 600), ("ont.fq.gz", 12_000)):
        fastq(name, 8, length)
    for name in ("r1.fa", "r2.fa"):
        with open(root / name, "w") as f:
            fastx.write_fasta(f, "r0", sim.random_genome(rng, 150))
    # The rule never opens an alignment file: its name decides.
    for name in ("x.bam", "x.cram", "i.bam", "i.bam.bai", "i.cram",
                 "i.cram.crai"):
        (root / name).write_bytes(b"")
    return root


@pytest.mark.parametrize("kind", list(KINDS))
def test_each_command_routes_each_input_kind_as_before(files, kind):
    names, interleaved, short, want = KINDS[kind]
    k = SimpleNamespace(interleaved=interleaved, short=short)
    paths_ = [str(files / n) for n in names]
    got = tuple("blocks" if inputs.takes_fastq_blocks(paths_, **ask(k))
                else "records" for ask in COMMANDS.values())
    assert got == want
    indexed = inputs.indexed_plan(paths_, reference="ref.fa") is not None
    assert indexed == kind.startswith("indexed")


@pytest.mark.filterwarnings("error::ResourceWarning")
def test_load_locus_closes_the_haplotype_file(tmp_path):
    """`load_locus` reads haplotypes.fa.gz through utils/io.py:smart_open,
    whose gzip reader closes the file beneath it."""
    rng = np.random.default_rng(1)
    seqs = [sim.random_genome(rng, 300) for _ in range(2)]
    ldir = paths.locus_dir(tmp_path, "L")
    with smart_create(ldir / paths.HAPLOTYPES) as f:
        for i, s in enumerate(seqs):
            fastx.write_fasta(f, f"h{i}", s)
    KmerCounts(25, [np.zeros(s.size - 24, np.uint16) for s in seqs]) \
        .save_npz(ldir / paths.KMER_COUNTS)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always", ResourceWarning)
        data = TG.load_locus(tmp_path, "L")
        gc.collect()
    assert not [w for w in seen if issubclass(w.category, ResourceWarning)]
    assert data.contig_set.contigs.names == ["h0", "h1"]
    for got, want in zip(data.contig_set.seqs, seqs):
        np.testing.assert_array_equal(got, want)
