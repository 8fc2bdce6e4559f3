"""The benchmark's inputs, drawn from `--seed`: a haplotype panel, the
genome it sits in, and samples of paired short reads or of single long
reads in gzip FASTQ.

The simulator functions are frozen copies of those of the port's `sim.py`
(`random_genome`, `mutate`, `simulate_structured_locus`, `make_paralog`)
and of `chip_smoke.py` (`build_genome`'s layout, `sample_pairs`,
`write_fastq_arrays`; for long reads `build_paralog_sample`'s and
`build_ont_paralog_sample`'s widened paralog locus and
`draw_single_reads`), so that a later change to the program does not
change the yardstick.  Two departures, both for set-up time: a sample's
true genotypes are drawn apart from its panel (every sample of a run shares
one database), and the locus pairs apply `sim.ErrorModel`'s per-base model
(deletion | insertion before | mismatch | match) to whole arrays at once.

A configuration whose `reads.technology` is `ont` or `hifi` is one of
single reads (`read_len_mean`, `read_len_sd`, the per-base error rates);
one whose panel has a `paralog` (`identity`, `spacer`, `margin`) widens
every locus around its gene.  Without those keys nothing here draws
otherwise than for paired reads.

Nothing here imports the port.
"""
from __future__ import annotations

import gzip
import threading
from dataclasses import dataclass
from pathlib import Path

import numpy as np

#: Streams of one seed: panel, then sample i at SAMPLE + i.
PANEL, FLANK_READS, SAMPLE = 0, 1, 2


def rng_for(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), stream])


def revcomp(codes: np.ndarray) -> np.ndarray:
    return np.where(codes < 4, 3 - codes, codes)[::-1].astype(np.int8)


# -- the panel ---------------------------------------------------------------

def random_genome(rng, length):
    return rng.integers(0, 4, size=length, dtype=np.int8)


def mutate(rng, seq, snp_rate=0.01, indel_rate=0.001, max_indel=8):
    """SNVs at `snp_rate` a base and indels of 1..max_indel at
    `indel_rate` a base (the port's sim.mutate)."""
    n = seq.size
    r = rng.random(n)
    snp = r < snp_rate
    out = np.where(snp, (seq + rng.integers(1, 4, n)) % 4, seq).astype(np.int8)
    pos = np.nonzero((r >= snp_rate) & (r < snp_rate + indel_rate))[0]
    if pos.size == 0:
        return out
    parts, prev = [], 0
    for p in pos:
        length = int(rng.integers(1, max_indel + 1))
        parts.append(out[prev:p])
        if rng.random() < 0.5:
            prev = min(p + length, n)
        else:
            parts.append(rng.integers(0, 4, size=length, dtype=np.int8))
            prev = p
    parts.append(out[prev:])
    return np.concatenate(parts)


@dataclass
class Locus:
    name: str
    haplotypes: list
    hap_names: list
    clade_of: list          # clade of each haplotype


def structured_locus(rng, name, length, n_clades, haps_per_clade,
                     clade_divergence, within_divergence):
    """The port's sim.simulate_structured_locus without its genotype draw:
    clade founders at `clade_divergence` from one ancestor, each with
    `haps_per_clade - 1` siblings at `within_divergence`."""
    ancestor = random_genome(rng, length)
    haps, clade_of = [], []
    for c in range(n_clades):
        founder = mutate(rng, ancestor, snp_rate=clade_divergence,
                         indel_rate=clade_divergence / 10)
        for i in range(haps_per_clade):
            haps.append(founder if i == 0 else mutate(
                rng, founder, snp_rate=within_divergence,
                indel_rate=within_divergence / 10))
            clade_of.append(c)
    order = rng.permutation(len(haps))
    return Locus(name, [haps[i] for i in order],
                 [f"{name}*{i:03d}" for i in range(len(haps))],
                 [clade_of[i] for i in order])


def make_paralog(rng, seq, identity):
    """The port's sim.make_paralog: a copy of `seq` at `identity`, nine
    tenths of the difference substitutions, a tenth indels."""
    div = max(1.0 - identity, 0.0)
    return mutate(rng, seq, snp_rate=div * 0.9, indel_rate=div * 0.1)


def widen(rng, locus: Locus, paralog: dict) -> Locus:
    """chip_smoke.py (k)'s widened locus: `margin` bases of flank, the
    gene's haplotype, a random spacer of `spacer` bases, the paralog
    (`make_paralog` of the first haplotype at `identity`) and `margin`
    bases of flank; every haplotype shares all but the gene."""
    para = make_paralog(rng, locus.haplotypes[0], paralog["identity"])
    spacer = random_genome(rng, paralog["spacer"])
    left = random_genome(rng, paralog["margin"])
    right = random_genome(rng, paralog["margin"])
    return Locus(locus.name,
                 [np.concatenate([left, h, spacer, para, right])
                  for h in locus.haplotypes],
                 locus.hap_names, locus.clade_of)


def build_panel(cfg: dict, seed: int):
    """(loci, genome, flanks, starts) of a configuration: every locus's
    first haplotype between random flanks of `flank_len`, as
    chip_smoke.py:build_genome lays them out; with a `paralog`, each locus
    widened around its gene (`widen`)."""
    rng = rng_for(seed, PANEL)
    p = cfg["panel"]
    loci = [structured_locus(rng, f"{p['prefix']}{i}", p["locus_len"],
                             p["n_clades"], p["haps_per_clade"],
                             p["clade_divergence"], p["within_divergence"])
            for i in range(p["n_loci"])]
    if "paralog" in p:
        loci = [widen(rng, lc, p["paralog"]) for lc in loci]
    flanks = [random_genome(rng, cfg["flank_len"])
              for _ in range(len(loci) + 1)]
    parts, starts, pos = [], [], 0
    for flank, lc in zip(flanks, loci):
        parts += [flank, lc.haplotypes[0]]
        pos += flank.size
        starts.append(pos)
        pos += lc.haplotypes[0].size
    parts.append(flanks[-1])
    return loci, np.concatenate(parts), flanks, starts


def draw_truth(rng, locus: Locus):
    """A diploid genotype: one haplotype from each of two distinct clades
    (the port's sim.simulate_structured_locus rule)."""
    c1, c2 = rng.choice(sorted(set(locus.clade_of)), size=2, replace=False)
    pick = [int(rng.choice([i for i, c in enumerate(locus.clade_of)
                            if c == cl])) for cl in (c1, c2)]
    return tuple(sorted(pick))


# -- reads -------------------------------------------------------------------

def sample_pairs(rng, copies, depth, sub_rate, read_len=150,
                 insert_mean=400.0, insert_sd=60.0):
    """chip_smoke.py:sample_pairs: pairs drawn uniformly from each sequence
    at `depth`, fragments N(insert_mean, insert_sd), mate 2 the reverse
    complement of the fragment's end, mates swapped in half the pairs,
    substitutions at `sub_rate`.  Returns ([N, read_len] int8, the same),
    in a random order."""
    firsts, seconds = [], []
    ar = np.arange(read_len)
    for seq in copies:
        n = int(depth * seq.size / (2 * read_len) + 0.5)
        ins = np.clip(np.rint(rng.normal(insert_mean, insert_sd, n)),
                      read_len, seq.size).astype(np.int64)
        start = (rng.random(n) * (seq.size - ins + 1)).astype(np.int64)
        m1 = seq[start[:, None] + ar]
        m2 = 3 - seq[(start + ins - read_len)[:, None] + ar][:, ::-1]
        swap = rng.random(n) < 0.5
        m1[swap], m2[swap] = m2[swap], m1[swap]
        for m in (m1, m2):
            sub = rng.random(m.shape, dtype=np.float32) < sub_rate
            m[sub] = (m[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
        firsts.append(m1)
        seconds.append(m2)
    order = rng.permutation(sum(m.shape[0] for m in firsts))
    return (np.concatenate(firsts)[order].astype(np.int8),
            np.concatenate(seconds)[order].astype(np.int8))


def apply_errors(rng, bases, mismatch, insertion, deletion):
    """sim.ErrorModel.apply on every row of `bases` [n, L] at once: per base
    a deletion, an insertion before it, a mismatch or a match, mutually
    exclusive.  Returns a list of n int8 arrays."""
    n, L = bases.shape
    r = rng.random((n, L))
    dele = r < deletion
    ins = (r >= deletion) & (r < deletion + insertion)
    mism = (r >= deletion + insertion) & (r < deletion + insertion + mismatch)
    vals = bases.astype(np.int8).copy()
    vals[mism] = (vals[mism] + rng.integers(1, 4, int(mism.sum()))) % 4
    counts = (1 - dele + ins).astype(np.int64).ravel()
    out = np.repeat(vals.ravel(), counts)
    ends = np.cumsum(counts)
    first = (ends - counts)[ins.ravel()]
    out[first] = rng.integers(0, 4, first.size)
    row_ends = ends.reshape(n, L)[:, -1]
    return np.split(out, row_ends[:-1])


def locus_pairs(rng, haps, depth, reads):
    """Pairs from the true haplotypes at `depth` each, as
    sim.simulate_paired_reads draws them (without GC bias): fragment
    N(insert_mean, insert_sd) clipped to [read_len, hap length], uniform
    start, the error model on both mates, mates swapped in half the
    pairs.  Returns (mates 1, mates 2) as lists of int8 arrays."""
    L = reads["read_len"]
    m1s, m2s = [], []
    for seq in haps:
        n = int(depth * seq.size / (2 * L) + 0.5)
        ins = np.clip(np.rint(rng.normal(reads["insert_mean"],
                                         reads["insert_sd"], n)),
                      L, seq.size).astype(np.int64)
        start = (rng.random(n) * (seq.size - ins + 1)).astype(np.int64)
        ar = np.arange(L)
        m1s.append(seq[start[:, None] + ar])
        m2s.append(3 - seq[(start + ins - L)[:, None] + ar][:, ::-1])
    m1, m2 = np.concatenate(m1s), np.concatenate(m2s)
    swap = rng.random(m1.shape[0]) < 0.5
    m1[swap], m2[swap] = m2[swap], m1[swap]
    err = (reads["mismatch"], reads["insertion"], reads["deletion"])
    return apply_errors(rng, m1, *err), apply_errors(rng, m2, *err)


@dataclass
class Sample:
    """One sample: its true genotype at every locus and its locus pairs;
    the flank pairs are shared by every sample of a run.  A sample of
    single reads holds all its reads in `mates1`, and `mates2` is None."""
    truth: dict             # locus name -> (hap index, hap index)
    names: list
    mates1: list
    mates2: list | None


def draw_sample(loci, cfg, traffic, seed, index) -> Sample:
    rng = rng_for(seed, SAMPLE + index)
    truth, names, m1, m2 = {}, [], [], []
    for lc in loci:
        gt = draw_truth(rng, lc)
        truth[lc.name] = gt
        a, b = locus_pairs(rng, [lc.haplotypes[i] for i in gt],
                           traffic["locus_depth"], cfg["reads"])
        names += [f"{lc.name}_{index}_{i}" for i in range(len(a))]
        m1 += a
        m2 += b
    return Sample(truth, names, m1, m2)


def flank_pairs(flanks, cfg, traffic, seed):
    """The off-target stream: `flank_multiple` x `locus_depth` from every
    flank (chip_smoke.py (f)'s background), substitutions only."""
    rng = rng_for(seed, FLANK_READS)
    r = cfg["reads"]
    return sample_pairs(rng, flanks,
                        traffic["locus_depth"] * traffic["flank_multiple"],
                        traffic["flank_sub_rate"], r["read_len"],
                        r["insert_mean"], r["insert_sd"])


def single_reads(cfg) -> bool:
    """The configuration's reads are single long reads."""
    return cfg["reads"]["technology"] in ("ont", "hifi")


def draw_single_reads(rng, copies, depth, length, errors, prefix):
    """chip_smoke.py:draw_single_reads: single reads along each sequence of
    `copies` at `depth` a copy, as `sim.simulate_single_reads` draws them
    (lengths N(mean, sd), at least 300; the reverse strand in half the
    draws; `errors` (mismatch, insertion, deletion) as
    `sim.ErrorModel.apply`'s per-base events, drawn for all bases of a read
    at once).  Returns (names, reads)."""
    mism_p, ins_p, del_p = errors
    names, reads = [], []
    for seq in copies:
        covered = 0
        while covered < depth * seq.size:
            span = min(max(int(rng.normal(*length)), 300), seq.size)
            start = int(rng.integers(0, seq.size - span + 1))
            frag = seq[start:start + span]
            if rng.random() < 0.5:
                frag = (3 - frag[::-1]).astype(np.int8)
            r = rng.random(span)
            out = frag.copy()
            mism = (r >= del_p + ins_p) & (r < del_p + ins_p + mism_p)
            out[mism] = (out[mism] + rng.integers(1, 4, int(mism.sum()))) % 4
            keep = r >= del_p
            ins = (r < del_p + ins_p)[keep]
            extra = rng.integers(0, 4, int(ins.sum())).astype(np.int8)
            reads.append(np.insert(out[keep], np.flatnonzero(ins), extra))
            names.append(f"{prefix}{len(names):06d}")
            covered += span
    return names, reads


def draw_single_sample(loci, flanks, cfg, traffic, seed, index) -> Sample:
    """A sample of single reads, as chip_smoke.py (k) draws one: two copies
    of the whole contig, each with one haplotype of every locus's true
    genotype in the locus's place, and reads along both.  The off-target
    part (the flanks) is read at `locus_depth` x `flank_multiple` a copy
    and the loci at `locus_depth`: both copies are read whole at the lower
    of the two depths, and the loci's (or the flanks') stretches of each
    copy alone again up to the higher."""
    rng = rng_for(seed, SAMPLE + index)
    truth = {lc.name: draw_truth(rng, lc) for lc in loci}
    haps = [[lc.haplotypes[truth[lc.name][c]] for lc in loci]
            for c in (0, 1)]
    copies = [np.concatenate([p for pair in zip(flanks, h) for p in pair]
                             + [flanks[-1]]) for h in haps]
    r = cfg["reads"]
    draw = dict(length=(r["read_len_mean"], r["read_len_sd"]),
                errors=(r["mismatch"], r["insertion"], r["deletion"]))
    on, off = traffic["locus_depth"], \
        traffic["locus_depth"] * traffic["flank_multiple"]
    names, reads = draw_single_reads(rng, copies, min(on, off),
                                     prefix=f"s{index}_", **draw)
    if on != off:
        more, part = ([h for c in haps for h in c], "loci") if on > off \
            else (flanks * 2, "flanks")
        n, rd = draw_single_reads(rng, more, abs(on - off),
                                  prefix=f"s{index}_{part}_", **draw)
        names += n
        reads += rd
    return Sample(truth, names, reads, None)


# -- files -------------------------------------------------------------------

ACGTN = np.frombuffer(b"ACGTN", np.uint8)


def fastq_bytes(names, seqs) -> bytes:
    """FASTQ records of reads of any length, qualities `I`."""
    out = []
    for name, s in zip(names, seqs):
        b = ACGTN[s].tobytes()
        out.append(b"@%s\n%s\n+\n%s\n" % (name.encode(), b, b"I" * len(b)))
    return b"".join(out)


def fastq_array_bytes(reads, prefix) -> bytes:
    """FASTQ records of equal-length reads [n, L] as one byte string,
    names `<prefix><index, 8 digits>` (chip_smoke.py:write_fastq_arrays)."""
    n, L = reads.shape
    digits = (np.arange(n)[:, None] // 10 ** np.arange(7, -1, -1)) % 10
    name = np.concatenate([np.full((n, 1), ord("@")),
                           np.frombuffer(prefix.encode(), np.uint8)[None, :]
                           .repeat(n, 0), digits + ord("0"),
                           np.full((n, 1), ord("\n"))], 1)
    plus = np.frombuffer(b"\n+\n", np.uint8)[None, :].repeat(n, 0)
    rec = np.concatenate([name, ACGTN[reads], plus, np.full((n, L), ord("I")),
                          np.full((n, 1), ord("\n"))], 1).astype(np.uint8)
    return rec.tobytes()


def flank_names(n: int, prefix="bg"):
    return [f"{prefix}{i:08d}" for i in range(n)]


def _gzip_to(path, data: bytes):
    with open(path, "wb") as f:
        f.write(gzip.compress(data, compresslevel=1))


def write_gzip_pair(paths, datas):
    """Compresses the two mates' files in two threads (zlib releases the
    interpreter lock)."""
    threads = [threading.Thread(target=_gzip_to, args=(p, d))
               for p, d in zip(paths, datas)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def write_sample_fastq(tmp: Path, index, sample: Sample, flank_gz):
    """reads_<index>_{1,2}.fq.gz: the sample's locus pairs, then the
    shared flank pairs appended as the gzip members in `flank_gz`."""
    out = [tmp / f"reads_{index}_1.fq.gz", tmp / f"reads_{index}_2.fq.gz"]
    write_gzip_pair(out, [fastq_bytes(sample.names, sample.mates1),
                          fastq_bytes(sample.names, sample.mates2)])
    for path, gz in zip(out, flank_gz):
        if gz is None:
            continue
        with open(path, "ab") as dst, open(gz, "rb") as src:
            while chunk := src.read(1 << 24):
                dst.write(chunk)
    return out


def write_sample_single(tmp: Path, index, sample: Sample):
    """reads_<index>.fq.gz: the sample's single reads."""
    out = tmp / f"reads_{index}.fq.gz"
    _gzip_to(out, fastq_bytes(sample.names, sample.mates1))
    return [out]


def write_fasta(f, name, seq):
    f.write(f">{name}\n".encode())
    f.write(ACGTN[seq].tobytes())
    f.write(b"\n")


def write_add_inputs(tmp: Path, loci, genome, starts):
    """ref.fa (one contig `chr1`), loci.bed and haps_<locus>.fa, the
    inputs of the port's `add`."""
    with open(tmp / "ref.fa", "wb") as f:
        write_fasta(f, "chr1", genome)
    rows = []
    for lc, pos in zip(loci, starts):
        rows.append(f"chr1\t{pos}\t{pos + lc.haplotypes[0].size}\t{lc.name}")
        with open(tmp / f"haps_{lc.name}.fa", "wb") as f:
            for name, seq in zip(lc.hap_names, lc.haplotypes):
                write_fasta(f, name, seq)
    (tmp / "loci.bed").write_text("\n".join(rows) + "\n")
    return tmp / "ref.fa", tmp / "loci.bed", str(tmp / "haps_{}.fa")


def write_background_model(prep: Path, model: dict):
    """<prep>/bg/distr.json.gz, the saved background distributions that
    `genotype -p` reads (the port's BgDistr JSON layout)."""
    import json
    (prep / "bg").mkdir(parents=True, exist_ok=True)
    with gzip.open(prep / "bg" / "distr.json.gz", "wt") as f:
        json.dump(model, f)
