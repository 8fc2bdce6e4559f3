"""Pangenome VCF → haplotype sequences.

Counterpart of reference seq/panvcf.rs: given a reference sub-sequence and a
VCF with phased sample genotypes, reconstruct each haplotype by applying its
allele at every variant (`reconstruct_sequences`, panvcf.rs:223+), with
haplotype naming "<sample>.<hap_ix>" from sample ploidy (:53-146), a
tolerance for unknown genotypes, and overlapping-variant handling (keep the
first, skip overlaps).

Pure-Python VCF parsing (no htslib in this environment); handles plain and
gzipped VCF with phased (|) or unphased (/) separators.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.io import smart_open
from . import dna
from ..utils.logging import get_logger

logger = get_logger("panvcf")


@dataclass
class Variant:
    pos: int                 # 0-based on the contig
    ref: str
    alts: list
    gts: list                # per haplotype column: allele index or -1


def read_vcf(path, contig: str, start: int, end: int):
    """Parses variants of `contig` overlapping [start, end).  Returns
    (haplotype_names, variants)."""
    samples = []
    hap_names = []
    ploidies = []
    variants = []
    with smart_open(path) as f:
        for line in f:
            if line.startswith("##"):
                continue
            if line.startswith("#CHROM"):
                samples = line.rstrip("\n").split("\t")[9:]
                continue
            fields = line.rstrip("\n").split("\t")
            if fields[0] != contig:
                continue
            pos = int(fields[1]) - 1
            ref = fields[3].upper()
            if pos + len(ref) <= start or pos >= end:
                continue
            alts = [a.upper() for a in fields[4].split(",") if a != "."]
            fmt = fields[8].split(":")
            try:
                gt_ix = fmt.index("GT")
            except ValueError:
                continue
            gts = []
            row_ploidies = []
            for col in fields[9:]:
                gt_str = col.split(":")[gt_ix]
                alleles = gt_str.replace("|", "/").split("/")
                row_ploidies.append(len(alleles))
                for a in alleles:
                    gts.append(-1 if a in (".", "") else int(a))
            if not ploidies:
                ploidies = row_ploidies
                for s, p in zip(samples, ploidies):
                    for i in range(p):
                        hap_names.append(f"{s}.{i + 1}" if p > 1 else s)
            variants.append(Variant(pos, ref, alts, gts))
    return hap_names, variants


def reconstruct_sequences(ref_seq: np.ndarray, ref_start: int, hap_names,
                          variants, max_unknown_frac: float = 0.1,
                          leave_out=()) -> list[tuple[str, np.ndarray]]:
    """Applies phased genotypes to the reference sub-sequence
    (panvcf.rs:223+).  `ref_seq` covers [ref_start, ref_start + len).
    Haplotypes with more than `max_unknown_frac` unknown genotypes are
    dropped; overlapping variants keep the first."""
    n_haps = len(hap_names)
    ref_str = dna.decode(ref_seq)
    out = []
    keep_ix = [i for i, n in enumerate(hap_names)
               if n.split(".")[0] not in leave_out]
    n_vars = max(len(variants), 1)
    for h in keep_ix:
        parts = []
        cursor = 0
        unknown = 0
        last_end = -1
        for v in variants:
            local = v.pos - ref_start
            if local < 0 or local + len(v.ref) > len(ref_str):
                continue
            if local < last_end:   # overlapping variant: keep the first
                continue
            allele = v.gts[h] if h < len(v.gts) else -1
            if allele < 0:
                unknown += 1
                allele = 0
            if allele == 0:
                continue
            alt = v.alts[allele - 1]
            if any(ch not in "ACGTN" for ch in alt):
                continue            # symbolic alt
            parts.append(ref_str[cursor:local])
            parts.append(alt)
            cursor = local + len(v.ref)
            last_end = cursor
        if unknown / n_vars > max_unknown_frac:
            logger.warning("Dropping haplotype %s: %.0f%% unknown genotypes",
                           hap_names[h], 100.0 * unknown / n_vars)
            continue
        parts.append(ref_str[cursor:])
        out.append((hap_names[h], dna.encode("".join(parts))))
    return out


def haplotypes_from_vcf(vcf_path, ref_seq: np.ndarray, contig: str,
                        start: int, end: int, leave_out=(),
                        max_unknown_frac: float = 0.1):
    """Full path: parse + reconstruct; prepends the reference itself as
    haplotype '<contig>:<start>-<end>' (add.rs includes the ref allele)."""
    hap_names, variants = read_vcf(vcf_path, contig, start, end)
    haps = reconstruct_sequences(ref_seq, start, hap_names, variants,
                                 max_unknown_frac=max_unknown_frac,
                                 leave_out=leave_out)
    ref_name = f"{contig}:{start + 1}-{end}"
    return [(ref_name, ref_seq.copy())] + haps
