"""Carries state over from the JAX reference package.

The system has no weights; its state is the locus tensors, the haplotype
panel with its k-mer counts, the candidate alignments and the background
model.  `from_reference` takes one of the reference package's objects **by
duck typing** — it reads attributes and never imports that package — and
returns this package's object holding equal values, so that both packages
can be run on identical inputs.

The on-disk forms (the `BgDistr` JSON, `KmerCounts` npz, the locus DB's
FASTA) are shared: each package's own loader reads a file the other wrote.
"""
from __future__ import annotations

import numpy as np

from .bg import BgDistr
from .model.assgn import LocusTensors
from .model.locs import AllAlignments, MateAlnTable
from .model.windows import ContigInfoPack
from .pipeline import LocusData
from .seq.contigs import ContigSet
from .seq.counts import KmerCounts


def _locus_tensors(o) -> LocusTensors:
    return LocusTensors(np.asarray(o.hap_prob, np.float32),
                        np.asarray(o.hap_mid, np.int32),
                        np.asarray(o.unmapped_prob, np.float32),
                        int(o.n_haps), int(o.n_reads), int(o.kh))


def _contig_info_pack(o) -> ContigInfoPack:
    return ContigInfoPack(
        n_haps=int(o.n_haps), max_len=int(o.max_len),
        max_windows=int(o.max_windows),
        n_windows=np.asarray(o.n_windows, np.int32),
        reg_start=np.asarray(o.reg_start, np.int32),
        contig_len=np.asarray(o.contig_len, np.int32),
        window_size=int(o.window_size),
        gc_at=np.asarray(o.gc_at, np.int32),
        weight_at=np.asarray(o.weight_at, np.float32))


def _mate_aln_table(o) -> MateAlnTable:
    return MateAlnTable(*(np.array(getattr(o, f))
                          for f in MateAlnTable._FIELDS))


def _all_alignments(o) -> AllAlignments:
    arrays = ("read_ix", "weights", "unmapped", "c_read", "c_hap", "c_prob",
              "c_mid1", "c_mid2", "c_a1", "c_a2", "used_mask")
    return AllAlignments(n_haps=int(o.n_haps),
                         table=_mate_aln_table(o.table),
                         names=list(o.names),
                         **{f: np.array(getattr(o, f)) for f in arrays})


def _contig_set(o) -> ContigSet:
    return ContigSet(o.tag, list(o.contigs.names),
                     [np.array(s, np.int8) for s in o.seqs])


def _kmer_counts(o) -> KmerCounts:
    return KmerCounts(int(o.k), [np.array(c) for c in o.counts])


def _bg_distr(o) -> BgDistr:
    # The JSON form is the shared on-disk form; Python floats survive it
    # exactly.
    return BgDistr.from_json(o.to_json())


def _locus_data(o) -> LocusData:
    dist = None if o.dist_matrix is None else np.array(o.dist_matrix)
    return LocusData(_contig_set(o.contig_set), _kmer_counts(o.kmer_counts),
                     dist)


def device_index_from_reference(o):
    """The reference package's `DeviceIndex` (numpy fields) as this
    package's: the same sorted keys and locus bitmaps, so that both
    recruiters look reads up in identical tables."""
    from .ops.recruit import DeviceIndex
    u32 = np.uint32
    return DeviceIndex(
        keys=np.array(o.keys, u32), fw_mask=np.array(o.fw_mask, u32),
        bw_mask=np.array(o.bw_mask, u32), rare_mask=np.array(o.rare_mask, u32),
        n_loci=int(o.n_loci), n_groups=int(o.n_groups), k=int(o.k),
        w=int(o.w), frac_p=int(o.frac_p), frac_q=int(o.frac_q))


_CONVERTERS = {
    "LocusTensors": _locus_tensors,
    "ContigInfoPack": _contig_info_pack,
    "MateAlnTable": _mate_aln_table,
    "AllAlignments": _all_alignments,
    "ContigSet": _contig_set,
    "KmerCounts": _kmer_counts,
    "BgDistr": _bg_distr,
    "LocusData": _locus_data,
    "DeviceIndex": device_index_from_reference,
}


def from_reference(obj):
    """Returns this package's counterpart of a reference-package object
    (LocusTensors, ContigInfoPack, AllAlignments, MateAlnTable, ContigSet,
    KmerCounts, BgDistr, LocusData or DeviceIndex), chosen by the object's
    class name."""
    conv = _CONVERTERS.get(type(obj).__name__)
    if conv is None:
        raise TypeError(f"from_reference: no counterpart for "
                        f"{type(obj).__name__}")
    return conv(obj)
