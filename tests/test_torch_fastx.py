"""The port's paired FASTQ reader (`seq/fastx.py:fast_paired_batches`):
each mate file inflated and parsed on a thread of its own, names kept as
bytes until a row is indexed.  Its batches are held against the records
written and the names against the eager decoding of each header (up to
the first space, tab or newline, as UTF-8); a read too wide for the
batch, met on a mate's thread, restarts recruitment at the wider width;
closing the stream stops every thread it started and closes its files."""
import gzip
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from locityper_tpu_torch import sim
from locityper_tpu_torch.commands import genotype as TG
from locityper_tpu_torch.seq import dna, fastx
from locityper_tpu_torch.seq.contigs import ContigSet
from locityper_tpu_torch.seq.counts import GenomeKmerCounter, off_target_counts
from locityper_tpu_torch.seq.recruit import RecruitParams
from locityper_tpu_torch.utils import spans
from locityper_tpu_torch.utils.io import Prefetch

torch.set_num_threads(1)        # the suite runs several workers side by side

ACGT = np.frombuffer(b"ACGTN", np.uint8)
READER_THREADS = ("fastq-mate1", "fastq-mate2", "prefetch")


def fastq(headers, seqs) -> bytes:
    return b"".join(b"@%s\n%s\n+\n%s\n" % (h.encode(), ACGT[s].tobytes(),
                                           b"I" * s.size)
                    for h, s in zip(headers, seqs))


def write_mates(tmp, headers, seqs1, seqs2, members=1):
    """r_1.fq.gz and r_2.fq.gz, each written as `members` gzip members one
    after another (bench_port/gen.py:write_sample_fastq appends a second)."""
    paths = [tmp / "r_1.fq.gz", tmp / "r_2.fq.gz"]
    for path, seqs in zip(paths, (seqs1, seqs2)):
        cuts = np.linspace(0, len(seqs), members + 1).astype(int)
        with open(path, "wb") as f:
            for a, b in zip(cuts[:-1], cuts[1:]):
                f.write(gzip.compress(fastq(headers[a:b], seqs[a:b]),
                                      compresslevel=1))
    return paths


def reader_threads():
    return [t for t in threading.enumerate() if t.name in READER_THREADS]


# (headers of record i, records, batch, parse chunk bytes, gzip members)
CASES = {
    "plain": (lambda i: f"r{i:05d}", 300, 64, None, 1),
    "comment_after_space": (lambda i: f"r{i} 1:N:0:ACGT extra", 300, 64,
                            None, 1),
    "comment_after_tab": (lambda i: f"read.{i}/1\tBC:Z:AC GT", 300, 64,
                          None, 1),
    "utf8": (lambda i: f"lé{i}-µ", 120, 50, None, 1),
    # Chunks of 97 bytes: record, name and newline boundaries all fall
    # inside chunks and between them.
    "chunk_inside_name": (lambda i: f"{'n' * 40}{i}", 200, 32, 97, 1),
    "padded_final_batch": (lambda i: f"p{i}", 101, 25, 1000, 1),
    "two_gzip_members": (lambda i: f"bg{i:08d} x", 257, 64, 4096, 2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_lazy_names_and_batches_equal_the_eager_reader(tmp_path, case,
                                                       monkeypatch):
    header, n, batch, chunk, members = CASES[case]
    if chunk is not None:
        monkeypatch.setattr(fastx, "_CHUNK_BYTES", chunk)
    rng = np.random.default_rng(25)
    headers = [header(i) for i in range(n)]
    seqs1 = [rng.integers(0, 5, rng.integers(100, 151)).astype(np.int8)
             for _ in range(n)]
    seqs2 = [rng.integers(0, 5, rng.integers(100, 151)).astype(np.int8)
             for _ in range(n)]
    paths = write_mates(tmp_path, headers, seqs1, seqs2, members)
    # The eager decoding: each header's bytes up to the first space, tab
    # or newline, decoded.
    eager = [h.encode().split(b" ")[0].split(b"\t")[0].decode()
             for h in headers]
    got_names, row = [], 0
    with spans.call("test") as root:
        for names, m1, l1, m2, l2, count in fastx.fast_paired_batches(
                *paths, batch=batch, max_len=192):
            assert m1.shape == m2.shape == (batch, 192)
            assert len(names) == count
            for m, lens, seqs in ((m1, l1, seqs1), (m2, l2, seqs2)):
                for i in range(count):
                    s = seqs[row + i]
                    assert lens[i] == s.size
                    np.testing.assert_array_equal(m[i, :s.size], s)
                    assert (m[i, s.size:] == dna.N_CODE).all()
                assert (m[count:] == dna.N_CODE).all()    # padding rows
                assert (lens[count:] == 0).all()
            assert names[-1] == names[count - 1]
            assert list(names[1:]) == [names[i] for i in range(1, count)]
            got_names.extend(names)
            row += count
    assert row == n and got_names == eager
    # One decode a name taken: three a row above.
    assert root.attrs["names_decoded"] == 3 * n


def locus_world(tmp, long_mate):
    """One 4 kb locus, 150 bp pairs from it and from the genome around it;
    the 20th pair from the end carries a 300 bp mate `long_mate`, read from
    the locus."""
    rng = np.random.default_rng(2500 + long_mate)
    locus = sim.simulate_locus(rng, "G", length=4000, n_haps=4,
                               divergence=0.02)
    genome = np.concatenate([sim.random_genome(rng, 20_000),
                             locus.haplotypes[0],
                             sim.random_genome(rng, 20_000)])
    counter = GenomeKmerCounter(25)
    counter.add_seq(genome)
    counter.finalize()
    kc = off_target_counts(counter, locus.haplotypes, locus.haplotypes[0])
    true_haps = [locus.haplotypes[i] for i in locus.true_genotype]
    loc = sim.simulate_paired_reads(rng, true_haps, depth=4, prefix="loc")
    bg = sim.simulate_paired_reads(rng, [genome[:20_000]], depth=1,
                                   prefix="bg")
    names = loc.names + bg.names
    mates = [list(loc.reads1 + bg.reads1), list(loc.reads2 + bg.reads2)]
    order = rng.permutation(len(names))
    names = [names[i] for i in order]
    mates = [[m[i] for i in order] for m in mates]
    mates[long_mate - 1][-20] = locus.haplotypes[0][1000:1300].copy()
    paths = write_mates(tmp, names, *mates)
    cset = ContigSet("G", locus.hap_names, locus.haplotypes)
    return {"G": SimpleNamespace(contig_set=cset, kmer_counts=kc)}, paths


@pytest.mark.parametrize("long_mate", [1, 2])
def test_a_too_wide_read_on_a_mate_thread_restarts_recruitment(
        tmp_path, long_mate, monkeypatch):
    loci, paths = locus_world(tmp_path, long_mate)
    monkeypatch.setattr(fastx, "_CHUNK_BYTES", 2048)
    raised_on, widths = [], []
    init = fastx.MaxLenExceeded.__init__

    def spy_init(self, max_seen):
        raised_on.append(threading.current_thread().name)
        init(self, max_seen)

    batches = fastx.fast_paired_batches

    def spy_batches(*args, **kwargs):
        widths.append(kwargs["max_len"])
        return batches(*args, **kwargs)

    monkeypatch.setattr(fastx.MaxLenExceeded, "__init__", spy_init)
    monkeypatch.setattr(fastx, "fast_paired_batches", spy_batches)
    rp = RecruitParams(match_frac=0.6)
    restarted, _ = TG.recruit_reads_fast(loci, *paths, rp, batch=32,
                                         max_len=192, device="cpu")
    assert raised_on == [f"fastq-mate{long_mate}"] and widths == [192, 320]
    assert not reader_threads()
    wide, _ = TG.recruit_reads_fast(loci, *paths, rp, batch=32, max_len=320,
                                    device="cpu")
    (pa, na), (pb, nb) = restarted["G"], wide["G"]
    assert len(na) > 10 and na == nb
    for (a1, a2), (b1, b2) in zip(pa, pb):
        np.testing.assert_array_equal(a1, b1)
        np.testing.assert_array_equal(a2, b2)


@pytest.mark.parametrize("through", ["generator", "Prefetch"])
def test_closing_the_stream_stops_its_threads_and_closes_its_files(
        tmp_path, through, monkeypatch):
    rng = np.random.default_rng(7)
    n = 2000
    seqs = [rng.integers(0, 4, 150).astype(np.int8) for _ in range(n)]
    paths = write_mates(tmp_path, [f"r{i}" for i in range(n)], seqs, seqs)
    # Small chunks and batches: both mate threads are still mid-file, their
    # queues full, when the consumer stops.
    monkeypatch.setattr(fastx, "_CHUNK_BYTES", 4096)
    opened = []
    smart_open_bytes = fastx.smart_open_bytes

    def spy_open(path):
        f = smart_open_bytes(path)
        opened.append(f)
        return f

    monkeypatch.setattr(fastx, "smart_open_bytes", spy_open)
    assert not reader_threads()
    stream = fastx.fast_paired_batches(*paths, batch=16, max_len=192)
    if through == "Prefetch":
        stream = Prefetch(stream, depth=2)
    first = next(stream)
    assert first[5] == 16 and list(first[0][:2]) == ["r0", "r1"]
    assert len(opened) == 2 and len(reader_threads()) >= 2
    stream.close()
    assert not reader_threads()
    assert all(f.closed for f in opened)
