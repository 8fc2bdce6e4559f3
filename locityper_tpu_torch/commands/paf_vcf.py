"""`paf-vcf` command: haplotype↔reference PAF alignments to VCF.

Counterpart of reference command/paf_vcf.rs (full 620-line semantics):
every haplotype's extended CIGAR against ONE reference haplotype becomes a
list of variant ranges (mismatch-adjacent indels merged, anchor bases,
left-canonized gaps — :203-308), overlapping ranges merge across
haplotypes into multi-allelic records (:494-537), haplotypes group into
diploid samples by the `NAME[._]K` convention (:539-578), and genotypes
are written phased with `.` for unknown alleles (:435-492).  `--region`
shifts coordinates into genome space; `--discarded` maps identical
haplotypes (add's discarded_haplotypes.txt) onto their kept twin; `.gz`
outputs are BGZF (tabix-compatible).
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..seq import dna, fastx
from ..utils.io import smart_create, smart_open
from ..utils.logging import get_logger

logger = get_logger("paf-vcf")

_CIGAR_RE = re.compile(r"(\d+)([=XIDMSH])")
# Sample grouping: lazy name + optional [._]digit haplotype suffix
# (paf_vcf.rs:549-551).
_HAP_RE = re.compile(r"^([0-9A-Za-z][0-9A-Za-z+._|~=@^-]*?)([._][1-9])?$")


def add_args(p):
    p.add_argument("-i", "--paf", "--input", dest="paf", required=True,
                   help="PAF file with cg:Z: extended CIGARs (from `align`)")
    p.add_argument("-f", "--fasta", default=None,
                   help="FASTA with every haplotype incl. the reference one")
    p.add_argument("-r", "--ref-hap", default=None,
                   help="Reference haplotype name (VCF coordinates)")
    p.add_argument("-o", "--output", required=True,
                   help="Merged multi-allelic VCF (.gz = BGZF)")
    p.add_argument("--separate", default=None,
                   help="Also write per-variant (unmerged) VCF here")
    p.add_argument("--region", default=None,
                   help="Genome region 'chrom:start[-end]' (1-based) or a "
                        "single-entry BED: output CHROM/POS shift "
                        "(paf_vcf.rs:137-186)")
    p.add_argument("--discarded", default=None,
                   help="add's discarded_haplotypes.txt: identical "
                        "haplotypes genotype via their kept twin")
    # Legacy pairwise interface (pre-round-2): -q/-t convert every PAF row
    # independently against its own target.
    p.add_argument("-q", "--query", default=None, help=None)
    p.add_argument("-t", "--target", default=None, help=None)
    return p


def parse_paf_line(line: str):
    f = line.rstrip("\n").split("\t")
    row = dict(qname=f[0], qlen=int(f[1]), qstart=int(f[2]), qend=int(f[3]),
               strand=f[4], tname=f[5], tlen=int(f[6]), tstart=int(f[7]),
               tend=int(f[8]), matches=int(f[9]), alen=int(f[10]),
               mapq=int(f[11]), cg=None)
    for tag in f[12:]:
        if tag.startswith("cg:Z:"):
            row["cg"] = tag[5:]
    return row


@dataclass
class VarRange:
    """Half-open variant range on reference + haplotype (paf_vcf.rs:182)."""
    ref_start: int
    ref_end: int
    hap_start: int
    hap_end: int


def process_haplotype(cg: str, qstart: int, tstart: int) -> list[VarRange]:
    """Extended CIGAR -> variant ranges (paf_vcf.rs:249-308): X runs stay
    as-is, indels take a left anchor base, an indel directly following a
    mismatch merges with it."""
    if tstart < 0 or qstart < 0:
        # Negative starts would silently emit negative variant positions;
        # current aligners clamp alignments to [0, tlen) so this cannot
        # happen today — guard in case window semantics ever change.
        raise ValueError(f"PAF alignment starts before position 0 "
                         f"(tstart={tstart}, qstart={qstart})")
    vars_: list[VarRange] = []
    rpos, qpos = tstart, qstart
    for m in _CIGAR_RE.finditer(cg):
        n, op = int(m.group(1)), m.group(2)
        if op == "=":
            rpos += n
            qpos += n
            continue
        if op in ("M", "H"):
            raise ValueError(f"Unexpected operation {op} in CIGAR (need "
                             "extended =/X CIGARs)")
        if op == "S":
            qpos += n
            continue
        rdiff = n if op in ("X", "D") else 0
        qdiff = n if op in ("X", "I") else 0
        need_new = True
        if vars_:
            last = vars_[-1]
            if last.ref_end == rpos and last.hap_end == qpos:
                last.ref_end = rpos + rdiff
                last.hap_end = qpos + qdiff
                need_new = False
        if need_new:
            if rdiff == qdiff:
                v = VarRange(rpos, rpos + rdiff, qpos, qpos + qdiff)
            elif rpos == 0 or qpos == 0:
                v = VarRange(rpos, rpos + rdiff + 1, qpos, qpos + qdiff + 1)
            else:
                v = VarRange(rpos - 1, rpos + rdiff, qpos - 1, qpos + qdiff)
            vars_.append(v)
        rpos += rdiff
        qpos += qdiff
    return vars_


def _gap_move_left(ref_seq, gap_start: int, gap_seq, min_start: int) -> int:
    """(paf_vcf.rs:207-215)."""
    last_ix = len(gap_seq) - 1
    k = last_ix
    while gap_start > min_start and gap_seq[k] == ref_seq[gap_start - 1]:
        gap_start -= 1
        k = k - 1 if k > 0 else last_ix
    return gap_start


def move_all_left(vars_: list[VarRange], ref_seq, hap_seq) -> None:
    """Left-canonize indel ranges in place (paf_vcf.rs:217-248)."""
    last_end = 0
    for var in vars_:
        min_start = last_end
        last_end = var.ref_end
        rlen = var.ref_end - var.ref_start
        alen = var.hap_end - var.hap_start
        if rlen == alen:
            continue
        var_ref = ref_seq[var.ref_start:var.ref_end]
        var_alt = hap_seq[var.hap_start:var.hap_end]
        prefix = min(rlen, alen)
        if not np.array_equal(var_ref[:prefix], var_alt[:prefix]):
            continue
        gap_seq = var_alt[prefix:] if prefix == rlen else var_ref[prefix:]
        gap_start = var.ref_start + prefix
        new_start = _gap_move_left(ref_seq, gap_start, gap_seq,
                                   min_start + prefix)
        shift = gap_start - new_start
        var.ref_start -= shift
        var.ref_end -= shift
        var.hap_start -= shift
        var.hap_end -= shift


def get_hap_ranges(ref_ranges, hap_vars: list[VarRange]):
    """Map merged reference ranges to haplotype ranges; None when a range
    boundary falls inside a haplotype variant (paf_vcf.rs:390-433)."""
    n = len(hap_vars)
    if n == 0:
        return [tuple(r) for r in ref_ranges]
    ends = [v.ref_end for v in hap_vars]
    starts = [v.ref_start for v in hap_vars]
    import bisect
    out = []
    for ref_start, ref_end in ref_ranges:
        diff = ref_end - ref_start
        i = bisect.bisect_right(ends, ref_start)
        j = bisect.bisect_left(starts, ref_end, i, n)
        if i == n:
            last = hap_vars[n - 1]
            shift = ref_start - last.ref_end
            out.append((last.hap_end + shift, last.hap_end + shift + diff))
            continue
        var1 = hap_vars[i]
        if i == j:
            left = var1.ref_start - ref_start
            out.append((var1.hap_start - left, var1.hap_start + diff - left))
            continue
        var2 = hap_vars[j - 1]
        if ref_start <= var1.ref_start and var2.ref_end <= ref_end:
            left = var1.ref_start - ref_start
            right = ref_end - var2.ref_end
            out.append((var1.hap_start - left, var2.hap_end + right))
        else:
            out.append(None)
    return out


def group_haplotypes(names: list[str]):
    """[(sample, [hap name | None, ...])] — `NAME[._]K` grouping with
    forced diploidy when any suffix is present (paf_vcf.rs:539-578)."""
    groups: dict[str, list] = {}
    for name in names:
        m = _HAP_RE.match(name)
        if not m:
            raise ValueError(f"Cannot parse contig name {name!r}")
        sample = m.group(1)
        suffix = m.group(2)
        hap = (ord(suffix[1]) - ord("1")) if suffix else 0
        vec = groups.setdefault(sample, [])
        new_len = max(len(vec), hap + 1, 1 if suffix is None else 2)
        vec.extend([None] * (new_len - len(vec)))
        vec[hap] = name
    return sorted(groups.items())


def load_region(spec: str):
    """'chrom:start[-end]' (1-based) or a single-entry BED -> (chrom,
    0-based shift) (paf_vcf.rs:137-186)."""
    p = Path(spec)
    if p.exists():
        for line in open(p):
            f = line.split()
            if f and not f[0].startswith("#"):
                return f[0], int(f[1])
        raise ValueError(f"{spec}: empty BED")
    chrom, _, rng = spec.partition(":")
    if not rng:
        raise ValueError(f"Bad region {spec!r} (need chrom:start[-end])")
    start = int(rng.split("-")[0].replace(",", ""))
    return chrom, start - 1


def _vcf_writer(path, samples, contig=None):
    if str(path).endswith(".gz"):
        from ..seq.bam import BgzfWriter
        out = BgzfWriter(path)
    else:
        out = open(path, "w")
    out.write("##fileformat=VCFv4.2\n")
    out.write('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n')
    if contig is not None:
        out.write(f"##contig=<ID={contig[0]},length={contig[1]}>\n")
    out.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
              + "\t".join(samples) + "\n")
    return out


def write_vcf(path, chrom, contig_len, shift, ref_ranges, hap_vars: dict,
              ref_seq, hap_seqs: dict, groups) -> int:
    """One VCF from merged (or unmerged) reference ranges
    (paf_vcf.rs:435-492).  Returns the number of records written."""
    hap_ranges = {name: get_hap_ranges(ref_ranges, hv)
                  for name, hv in hap_vars.items()}
    n_rec = 0
    with _vcf_writer(path, [s for s, _ in groups],
                     (chrom, contig_len)) as out:
        for i, (ref_start, ref_end) in enumerate(ref_ranges):
            alleles = [dna.decode(ref_seq[ref_start:ref_end])]
            allele_ix: dict[str, int | None] = {}
            for name, ranges in hap_ranges.items():
                rng = ranges[i]
                if rng is None:
                    allele_ix[name] = None
                    continue
                seq = dna.decode(hap_seqs[name][rng[0]:rng[1]])
                if "N" in seq or not seq:
                    allele_ix[name] = None
                    continue
                if seq in alleles:
                    allele_ix[name] = alleles.index(seq)
                else:
                    alleles.append(seq)
                    allele_ix[name] = len(alleles) - 1
            if len(alleles) == 1:
                continue
            gts = []
            for _sample, haps in groups:
                parts = []
                for h in haps:
                    ix = allele_ix.get(h) if h is not None else None
                    parts.append("." if ix is None else str(ix))
                gts.append("|".join(parts))
            out.write(f"{chrom}\t{ref_start + shift + 1}\t.\t{alleles[0]}\t"
                      f"{','.join(alleles[1:])}\t60\t.\t.\tGT\t"
                      + "\t".join(gts) + "\n")
            n_rec += 1
    return n_rec


def _run_legacy(args):
    """Pre-round-2 pairwise conversion: every PAF row independently vs its
    own target; one 0/1 column per query."""
    qseqs = dict(fastx.read_fasta(args.query))
    tseqs = dict(fastx.read_fasta(args.target))
    variants: dict[tuple, set] = {}
    samples = sorted(qseqs)
    n_rows = 0
    with smart_open(args.paf) as f:
        for line in f:
            if not line.strip():
                continue
            row = parse_paf_line(line)
            if row["cg"] is None:
                continue
            qseq = qseqs[row["qname"]]
            if row["strand"] == "-":
                qseq = dna.revcomp(qseq)
            tseq = tseqs[row["tname"]]
            vars_ = process_haplotype(row["cg"], row["qstart"], row["tstart"])
            move_all_left(vars_, tseq, qseq)
            for v in vars_:
                ref = dna.decode(tseq[v.ref_start:v.ref_end])
                alt = dna.decode(qseq[v.hap_start:v.hap_end])
                if ref != alt:
                    variants.setdefault((row["tname"], v.ref_start, ref, alt),
                                        set()).add(row["qname"])
            n_rows += 1
    with smart_create(args.output) as out:
        out.write("##fileformat=VCFv4.2\n")
        for name, seq in tseqs.items():
            out.write(f"##contig=<ID={name},length={seq.size}>\n")
        out.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                  + "\t".join(samples) + "\n")
        for (tname, pos, ref, alt), qs in sorted(variants.items()):
            gts = "\t".join("1" if s in qs else "0" for s in samples)
            out.write(f"{tname}\t{pos + 1}\t.\t{ref}\t{alt}\t.\tPASS\t.\tGT\t"
                      f"{gts}\n")
    logger.info("Converted %d PAF rows into %d variant records", n_rows,
                len(variants))
    return 0


def run(args):
    if args.query and args.target and not args.fasta:
        return _run_legacy(args)
    if not args.fasta or not args.ref_hap:
        raise ValueError("paf-vcf needs -f/--fasta and -r/--ref-hap "
                         "(or the legacy -q/-t pair)")
    seqs = dict(fastx.read_fasta(args.fasta))
    if args.ref_hap not in seqs:
        raise ValueError(f"Reference haplotype {args.ref_hap!r} not in "
                         f"{args.fasta}")
    ref_seq = seqs[args.ref_hap]

    # Variant ranges per haplotype from PAF rows targeting the ref hap.
    hap_vars: dict[str, list] = {}
    with smart_open(args.paf) as f:
        for line in f:
            if not line.strip():
                continue
            row = parse_paf_line(line)
            if row["tname"] != args.ref_hap or row["qname"] == args.ref_hap:
                continue
            if row["cg"] is None:
                logger.warning("PAF row %s has no cg:Z: tag, skipping",
                               row["qname"])
                continue
            if row["qname"] in hap_vars:
                continue                        # first (best) row wins
            qseq = seqs[row["qname"]]
            if row["strand"] == "-":
                qseq = dna.revcomp(qseq)
                seqs[row["qname"]] = qseq
            vars_ = process_haplotype(row["cg"], row["qstart"], row["tstart"])
            move_all_left(vars_, ref_seq, qseq)
            hap_vars[row["qname"]] = vars_
    missing = [n for n in seqs if n != args.ref_hap and n not in hap_vars]
    if missing:
        logger.warning("%d haplotype(s) have no PAF row vs %s: %s%s",
                       len(missing), args.ref_hap,
                       ",".join(missing[:5]), "..." if len(missing) > 5 else "")

    # Identical haplotypes discarded by `add` genotype via their kept twin.
    if args.discarded:
        for line in open(args.discarded):
            f = line.split()
            if len(f) >= 3 and f[2] in hap_vars:
                hap_vars[f[0]] = hap_vars[f[2]]
                seqs[f[0]] = seqs[f[2]]

    chrom, shift = (args.ref_hap, 0)
    if args.region:
        chrom, shift = load_region(args.region)

    groups = group_haplotypes(list(hap_vars))

    # Unique + merged reference ranges (paf_vcf.rs:498-530; touching
    # ranges do NOT merge).
    uniq = sorted({(v.ref_start, v.ref_end)
                   for vs in hap_vars.values() for v in vs})
    merged = []
    for start, end in uniq:
        if merged and start < merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])

    n = write_vcf(args.output, chrom, ref_seq.size, shift, merged, hap_vars,
                  ref_seq, seqs, groups)
    logger.info("%s: %d merged records over %d haplotypes, %d samples",
                args.output, n, len(hap_vars), len(groups))
    if args.separate:
        n2 = write_vcf(args.separate, chrom, ref_seq.size, shift, uniq,
                       hap_vars, ref_seq, seqs, groups)
        logger.info("%s: %d separate records", args.separate, n2)
    return 0
