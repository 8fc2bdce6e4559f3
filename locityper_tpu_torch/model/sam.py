"""Output alignments of reads under a called genotype (SAM text or BAM).

Counterpart of reference model/bam.rs (BAM via htslib; here the owned
writers emit either spec-conformant SAM.gz or real BGZF BAM —
`--out-bams` matches the reference's binary output, `--out-sams` keeps
the readable twin).  Each recruited read pair is reported at its most
frequently chosen location across solver attempts, one record per mapped
mate, with:
    CIGAR from the host traceback kernel re-run at the stored window
          (ops/traceback.py; exact same DP as the scoring kernel)
    MAPQ  from the assignment frequency (count_to_prob, bam.rs:54)
    XF:f  fraction of attempts choosing this location
    XW:f  read weight
"""
from __future__ import annotations

import numpy as np

from ..ops import align as A
from ..ops import traceback as T
from ..seq import dna
from ..seq.bam import BamWriter, pack_tag_f
from ..utils.io import smart_create

_SAM_OPS = "=XIDS"


def assignment_frequencies(assignments: np.ndarray, n_slots: int):
    """assignments [A, R] slot indices -> (top_slot [R], freq [R])."""
    A_, R = assignments.shape
    counts = np.zeros((R, n_slots), np.int32)
    for a in range(A_):
        counts[np.arange(R), assignments[a]] += 1
    top = counts.argmax(axis=1)
    freq = counts[np.arange(R), top] / A_
    return top, freq


def _slot_to_cand(ra, hap: int, k: int, kh: int):
    """Replays LocusTensors.build's slot assignment to find the PairCand
    behind (hap, slot k)."""
    s = 0
    for c in ra.cands:
        if c.hap != hap:
            continue
        if s == k:
            return c
        s += 1
        if s >= kh:
            break
    return None


def _mate_record(codes, aln, hap_seq, score_vec, band):
    """Regenerates the mate's CIGAR at the stored window.  Returns
    (pos0, cigar [(op, len)], oriented_codes, reverse, end0) or None."""
    if aln is None or codes is None:
        return None
    oriented = codes if aln.fwd else dna.revcomp(codes)
    win = A.extract_windows(hap_seq, np.array([aln.ws]),
                            oriented.size + band)[0]
    out = T.align_cigar(oriented, win, band, score_vec)
    if out is None:
        return None
    ops, lens, info, _ = out
    start_p, end_p = int(info[0]), int(info[1])
    cig = [(_SAM_OPS[int(o)], int(l)) for o, l in zip(ops, lens)]
    return (aln.ws + start_p, cig, oriented, not aln.fwd, aln.ws + end_p)


class _SamOut:
    """SAM.gz record sink."""

    def __init__(self, path, sq):
        self.names = [n for n, _ in sq]
        self.f = smart_create(path)
        self.f.write("@HD\tVN:1.6\tSO:unsorted\n")
        for n, ln in sq:
            self.f.write(f"@SQ\tSN:{n}\tLN:{ln}\n")
        self.f.write("@PG\tID:locityper-tpu\tPN:locityper-tpu\n")

    def rec(self, name, flag, rid, pos0, mapq, cig, next_rid, pnext0, tlen,
            seq_codes, tags):
        rname = "*" if rid < 0 else self.names[rid]
        pos_s = 0 if rid < 0 else max(pos0, 0) + 1
        cs = "".join(f"{l}{o}" for o, l in cig) if cig else "*"
        rnext = "*" if next_rid < 0 else "="
        seq = dna.decode(seq_codes) if seq_codes is not None else "*"
        tag_s = "".join(f"\t{t}:f:{v:.3f}" for t, v in tags)
        self.f.write(f"{name}\t{flag}\t{rname}\t{pos_s}\t{mapq}"
                     f"\t{cs}\t{rnext}\t{max(pnext0, -1) + 1}\t{tlen}\t"
                     f"{seq}\t*{tag_s}\n")

    def close(self):
        self.f.close()


class _BamOut:
    """Real BGZF BAM record sink (model/bam.rs role)."""

    def __init__(self, path, sq):
        self.w = BamWriter(path, [n for n, _ in sq], [l for _, l in sq])

    def rec(self, name, flag, rid, pos0, mapq, cig, next_rid, pnext0, tlen,
            seq_codes, tags):
        if seq_codes is None:
            seq_codes = np.empty(0, np.int8)
        tag_b = b"".join(pack_tag_f(t, v) for t, v in tags)
        self.w.write(name, flag, seq_codes, ref_id=rid,
                     pos=pos0 if rid >= 0 else -1, mapq=mapq,
                     cigar=[(o if o in "MIDNSHP=X" else "M", l)
                            for o, l in cig] if cig else None,
                     tags=tag_b, next_ref_id=next_rid, next_pos=pnext0,
                     tlen=tlen)

    def close(self):
        self.w.close()


def _open_sink(path, sq):
    return _BamOut(path, sq) if str(path).endswith(".bam") \
        else _SamOut(path, sq)


class _TeeOut:
    """Fans one record stream out to several sinks (BAM + SAM.gz twins):
    the expensive per-record work — host traceback CIGAR regeneration in
    _mate_record — runs ONCE regardless of how many formats are written."""

    def __init__(self, paths, sq):
        self.outs = [_open_sink(p, sq) for p in paths]

    def rec(self, *a, **kw):
        for o in self.outs:
            o.rec(*a, **kw)

    def close(self):
        for o in self.outs:
            o.close()


def _open_sinks(path, sq):
    if isinstance(path, (list, tuple)):
        if not path:
            raise ValueError("no output paths given — a zero-sink tee "
                             "would silently discard every record")
        return _TeeOut(path, sq) if len(path) != 1 else _open_sink(path[0],
                                                                   sq)
    return _open_sink(path, sq)


def write_all_sam(path, all_alns, read_pairs, hap_names, hap_lens, hap_seqs,
                  score_vec, band: int = 48) -> None:
    """Writes ALL candidate alignments of every modeled read to every
    haplotype (the reference's `--stop-after map` aln.bam stage,
    genotype.rs:1023-1074): one record per mapped mate per candidate, with
    traceback CIGARs; secondary candidates (per read, beyond its best one)
    carry FLAG 0x100.  XL:f is the candidate's pair ln-probability.
    A `.bam` path writes real BAM, anything else SAM.gz; a list of paths
    writes every format from one record pass."""
    out = _open_sinks(path, list(zip(hap_names, hap_lens)))
    try:
        for ra in all_alns.reads:
            c1, c2 = read_pairs[ra.read_ix]
            best = max((c.ln_prob for c in ra.cands), default=0.0)
            for c in ra.cands:
                sec = 0 if c.ln_prob >= best else 0x100
                rec1 = _mate_record(c1, c.aln1, hap_seqs[c.hap], score_vec,
                                    band)
                rec2 = _mate_record(c2, c.aln2, hap_seqs[c.hap], score_vec,
                                    band)
                paired = c2 is not None
                for mate_ix, rec, other in ((0, rec1, rec2), (1, rec2, rec1)):
                    if rec is None:
                        continue
                    pos0, cig, seq, rev, end0 = rec
                    flag = sec
                    if paired:
                        flag |= 0x1 | (0x40 if mate_ix == 0 else 0x80)
                        if other is None:
                            flag |= 0x8
                        else:
                            if other[3]:
                                flag |= 0x20
                            if other[3] != rev:
                                flag |= 0x2
                    if rev:
                        flag |= 0x10
                    next_rid, pnext0 = ((c.hap, other[0]) if (paired and other)
                                        else (-1, -1))
                    out.rec(ra.name, flag, c.hap, pos0, 0, cig, next_rid,
                            pnext0, 0, seq,
                            [("XL", c.ln_prob), ("XW", ra.weight)])
    finally:
        out.close()


def write_sam(path, gt, tensors, hap_names, hap_lens, read_names,
              assignments: np.ndarray, read_weights=None, all_alns=None,
              read_pairs=None, hap_seqs=None, score_vec=None,
              band: int = 48) -> None:
    """Writes one SAM.gz / BAM (by path suffix) for genotype
    `gt` = (h_0..h_{P-1}), any ploidy.

    tensors: model.assgn.LocusTensors; assignments: [A, R] final slot per
    attempt from the solver (slot layout: [s·Kh..(s+1)·Kh) = hap copy s,
    P·Kh = unmapped).  When `all_alns`/`read_pairs`/`hap_seqs`/`score_vec`
    are provided, records carry real CIGAR/POS/SEQ re-derived by the host
    traceback kernel; otherwise positions fall back to alignment middles.
    """
    kh = tensors.kh
    ploidy = len(gt)
    n_slots = ploidy * kh + 1
    top, freq = assignment_frequencies(assignments, n_slots)
    full = (all_alns is not None and read_pairs is not None
            and hap_seqs is not None and score_vec is not None)
    haps = sorted(set(gt))
    rid_of = {h: i for i, h in enumerate(haps)}
    out = _open_sinks(path, [(hap_names[h], hap_lens[h]) for h in haps])
    try:
        for r, name in enumerate(read_names):
            slot = int(top[r])
            p = float(freq[r])
            mapq = min(int(round(-10.0 * np.log10(max(1.0 - p, 1e-6)))), 60)
            tags = [("XF", p)]
            if read_weights is not None:
                tags.append(("XW", float(read_weights[r])))
            if slot == ploidy * kh:
                out.rec(name, 4, -1, -1, 0, None, -1, -1, 0, None, tags)
                continue
            hap = gt[slot // kh]
            rid = rid_of[hap]
            k = slot % kh
            cand = None
            if full:
                cand = _slot_to_cand(all_alns.reads[r], hap, k, kh)
            if cand is not None:
                c1, c2 = read_pairs[all_alns.reads[r].read_ix]
                rec1 = _mate_record(c1, cand.aln1, hap_seqs[hap], score_vec,
                                    band)
                rec2 = _mate_record(c2, cand.aln2, hap_seqs[hap], score_vec,
                                    band)
                paired = c2 is not None
                for mate_ix, rec, other in ((0, rec1, rec2), (1, rec2, rec1)):
                    if rec is None:
                        continue
                    pos0, cig, seq, rev, end0 = rec
                    tlen = 0
                    if other is not None:
                        lo = min(pos0, other[0])
                        hi = max(end0, other[4])
                        tlen = (hi - lo) if pos0 <= other[0] else (lo - hi)
                    flag = 0
                    if paired:
                        flag |= 0x1 | (0x40 if mate_ix == 0 else 0x80)
                        if other is None:
                            flag |= 0x8
                        else:
                            if other[3]:
                                flag |= 0x20
                            if other[3] != rev:
                                flag |= 0x2
                    if rev:
                        flag |= 0x10
                    next_rid, pnext0 = ((rid, other[0]) if (paired and other)
                                        else (-1, -1))
                    out.rec(name, flag, rid, pos0, mapq, cig, next_rid,
                            pnext0, tlen, seq, tags)
                if rec1 is not None or rec2 is not None:
                    continue
            # Fallback: middle-position record without CIGAR.
            mid1 = int(tensors.hap_mid[hap, r, k, 0])
            mid2 = int(tensors.hap_mid[hap, r, k, 1])
            pos = mid1 if mid1 >= 0 else mid2
            flag = 0 if mid1 >= 0 else 4
            out.rec(name, flag, rid, pos, mapq, None, -1, -1, 0, None, tags)
    finally:
        out.close()
