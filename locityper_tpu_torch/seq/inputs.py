"""Read inputs of the commands: which reader takes an input set, and the
per-record sources, (name, seq1, seq2|None) over FASTA/FASTQ, BAM and CRAM
files, scanned in full or fetched through their indexes.

Counterpart of reference seq/fastx.rs:586-887 (the input breadth) and
genotype.rs:792-870 (fetch regions).  `genotype`, `preproc` and `recruit`
take their inputs from here; the recruitment over them is
pipeline.py:recruit_reads_fast (two FASTQ files, in blocks) and
pipeline.py:recruit_records (any source, record by record).
"""
from __future__ import annotations

import contextlib
from pathlib import Path

from ..utils.logging import get_logger
from . import fastx

logger = get_logger("inputs")

FETCH_PADDING = 2000   # fetch-region padding around loci (genotype.rs:792)


def is_alignment_file(path) -> bool:
    return str(path).endswith((".bam", ".cram"))


def takes_fastq_blocks(inputs, interleaved: bool = False,
                       short_reads: bool = True,
                       max_pair_len: int | None = None) -> bool:
    """The routing rule: True when the input set goes to the two-file FASTQ
    block reader (pipeline.recruit_reads_fast, the native parser), False
    when it goes record by record (pipeline.recruit_records).

    The block reader takes exactly two FASTQ files (not `interleaved`) of
    short reads; with `max_pair_len`, also no read longer than that among
    the files' leading records (fastx.probe_fastq_max_len)."""
    return (len(inputs) == 2 and short_reads and not interleaved
            and not any(is_alignment_file(p) for p in inputs)
            and fastx.is_fastq_files(inputs)
            and (max_pair_len is None
                 or fastx.probe_fastq_max_len(inputs) <= max_pair_len))


def read_records(inputs, interleaved: bool = False, reference=None):
    """Yields (name, seq1, seq2|None) over the input set, in full.

    Mirrors the reference's input breadth (seq/fastx.rs:586-887): exactly
    two FASTX files = one paired read set; otherwise every entry (from -i
    or -I in-lists, freely mixing BAM/CRAM/FASTX) is an independent read
    set streamed in order.  BAM/CRAM pairing is auto-detected per file;
    `interleaved` applies to single FASTX files."""
    if (len(inputs) == 2 and not is_alignment_file(inputs[0])
            and not is_alignment_file(inputs[1])):
        for r1, r2 in fastx.read_pairs(inputs[0], inputs[1]):
            yield r1.name, r1.seq, r2.seq
        return
    for path in inputs:
        if is_alignment_file(path):
            from . import bam as bamio
            if bamio.is_paired_bam(path, reference=reference):
                for r1, r2 in bamio.read_bam_pairs(path, reference=reference):
                    yield r1.name, r1.seq, r2.seq
            else:
                for r in bamio.read_bam(path, reference=reference):
                    yield r.name, r.seq, None
        elif interleaved:
            for r1, r2 in fastx.read_pairs(path, interleaved=True):
                yield r1.name, r1.seq, r2.seq
        else:
            for r in fastx.read_fastx_auto(path):
                yield r.name, r.seq, None


def open_records(inputs, interleaved: bool = False, reference=None,
                 regions=None):
    """The per-record source of an input set: when `regions` ([(chrom,
    start, end)]) are given and every input is an indexed BAM/CRAM
    (`indexed_plan`), only the reads of those regions (padded by
    FETCH_PADDING) and the unplaced tail, fetched through the indexes;
    else `read_records`, the full scan."""
    plans = indexed_plan(inputs, reference) if regions is not None else None
    if plans is None:
        return read_records(inputs, interleaved, reference=reference)
    logger.info("Indexed input: fetching %d locus region(s) + unplaced tail "
                "from %d file(s) instead of a full scan", len(regions),
                len(plans))
    return indexed_read_iter(plans, regions, reference=reference)


def merge_regions(regions, padding: int):
    """{chrom: [(start, end), ...]} with padding applied and overlaps
    merged (genotype.rs:792-870 assembles fetch regions the same way)."""
    per: dict = {}
    for chrom, s, e in regions:
        per.setdefault(chrom, []).append([max(s - padding, 0), e + padding])
    for ivs in per.values():
        ivs.sort()
        merged = [ivs[0]]
        for iv in ivs[1:]:
            if iv[0] <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], iv[1])
            else:
                merged.append(iv)
        ivs[:] = merged
    return per


def indexed_plan(inputs, reference=None):
    """[(kind, path)] when EVERY input is an alignment file with an index
    on disk (.bam+.bai / .cram+.crai) — the only case where fetch-region
    recruitment can replace the full scan; else None (fastx.rs:586-887:
    htslib's indexed reader, any number of inputs)."""
    plans = []
    for p in inputs:
        sp = str(p)
        if sp.endswith(".bam") and Path(sp + ".bai").exists():
            plans.append(("bai", p))
        elif sp.endswith(".cram") and Path(sp + ".crai").exists():
            if reference is None:
                return None       # reference-based slices need the FASTA
            plans.append(("crai", p))
        else:
            return None
    return plans


def pair_fetched(records):
    """(name, seq1, seq2|None) from a fetched record stream of ONE file:
    mates pair by name within the fetched set; orphans (mate outside
    every region) pass as single (fastx.rs:640-660)."""
    pending: dict = {}
    for rec in records:
        if not rec.is_paired:
            yield rec.name, rec.seq, None
            continue
        other = pending.pop(rec.name, None)
        if other is None:
            pending[rec.name] = rec
        else:
            r1, r2 = (rec, other) if rec.mate_ix == 0 else (other, rec)
            yield r1.name, r1.seq, r2.seq
    for rec in pending.values():
        yield rec.name, rec.seq, None


def bai_records(bam_path, per, unplaced: bool = True):
    """The records of a BAM file in the merged regions `per` (in order),
    then, with `unplaced`, its unplaced tail, through its .bai."""
    from . import bai as baio

    idx = baio.BaiIndex.load(str(bam_path) + ".bai")
    with open(bam_path, "rb") as fh:
        names, _lens = baio.read_header(baio.VirtualReader(fh))
    rid_of = {n: i for i, n in enumerate(names)}
    for chrom, ivs in per.items():
        rid = rid_of.get(chrom)
        if rid is None:
            continue
        for s, e in ivs:
            yield from baio.fetch(bam_path, idx, rid, s, e)
    if unplaced:
        yield from baio.fetch_unplaced(bam_path, idx)


def crai_records(cram_path, per, reference, unplaced: bool = True):
    """`bai_records` for a CRAM file through its .crai.  One CramFile
    serves every region (opening one parses the reference FASTA —
    per-region reopens would re-decode the genome per interval)."""
    from . import crai as craio
    from .cram import CramFile

    idx = craio.CraiIndex.load(str(cram_path) + ".crai")
    with CramFile(cram_path, reference) as cf:
        rid_of = {n: i for i, n in enumerate(cf.ref_names)}
        for chrom, ivs in per.items():
            rid = rid_of.get(chrom)
            if rid is None:
                continue
            for s, e in ivs:
                yield from craio.fetch(cram_path, idx, rid, s, e, cram=cf)
        if unplaced:
            yield from craio.fetch_unplaced(cram_path, idx, cram=cf)


def indexed_read_iter(plans, regions, padding: int = FETCH_PADDING,
                      reference=None):
    """(name, seq1, seq2|None) via indexed fetch over the padded, merged
    locus regions plus the unplaced tail, across ANY number of indexed
    BAM/CRAM inputs — the reference's fetch-region recruitment
    (genotype.rs:792-870, fastx.rs:586-887).  Each input is an
    independent read set; mates pair within their own file."""
    per = merge_regions(regions, padding)
    for kind, path in plans:
        maker = (bai_records(path, per) if kind == "bai"
                 else crai_records(path, per, reference))
        # closing() propagates an early-exit close into the record
        # generator so the underlying BAM/CRAM handle is released
        # deterministically, not at GC time.
        with contextlib.closing(maker) as records:
            yield from pair_fetched(records)
