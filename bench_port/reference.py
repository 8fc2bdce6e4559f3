"""The plain reference that decides `correct`: plain PyTorch (on the card in
a run, on the CPU in the tests), independent of the program.  It imports
nothing of the port, of `locityper_tpu` or of JAX, and takes nothing that
the program made: the panel, the genome and the reads come from `gen.py`.

* Recruitment, worked out again from the panel, the genome and the reads:
  minimizers (k 15, w 10, canonical 2-bit k-mers under the 32-bit murmur3
  mix), every locus's minimizer table with its strand bits and its "rare"
  bit (the 25-mer under the minimizer occurs fewer than 10 times in the
  genome outside the locus), and the paired-read rule of Locityper's
  recruit.rs:885-932 with match fraction 1/2.  A read is scanned as the
  card scans it, in a row padded with N, so windows that run past its end
  count; a haplotype is scanned whole windows only.
* Single reads (a sample of long reads), by recruit.rs's rules for one
  read with match fraction 1/2, the long-read technologies' default: a
  read of over 500 bases by the long-read rule (:966-997: the rare matches
  of the better strand against min(`-L/--match-len` 2000 as
  `STRETCH_MINIMS` minimizers, the minimizers that strand does not hit) x
  1/2, and, for a read of that many minimizers or more, a stretch whose
  maximum subarray of +1 a hit, +3 more if rare, -1 a minimizer reaches
  `STRETCH_SCORE`, summed minimizer by minimizer as recruit.rs:940-964
  does), in a row of its power-of-two length class from 1,024 bases; a
  shorter one by the single short-read rule (:852-881), all such reads of
  a sample in one row width, the next multiple of 64 of the longest.
* The banded aligner, a frozen copy of the port's plain version
  (`ops/align.py:align_batch_reference`), run on jobs the timed path
  launched.
* The annealer's end state re-scored: depth of every window from the final
  assignment, the window tables at that depth and the candidates'
  ln-probabilities, summed in float64 (`ops/solver_chains.py`'s own
  definition of the likelihood it returns); and every move of one read to
  another of its candidates scored from that state, to tell whether the
  annealer's closing polish left a step up.

`bits` and `dtype` give the controls: keys cut to 16 bits, arithmetic in
bfloat16.
"""
from __future__ import annotations

import numpy as np
import torch

K, W_MIN = 15, 10            # minimizer k-mer and window (genotype's -m 15,10)
COUNT_K = 25                 # add's -k: the k-mers counted in the genome
RARE_BELOW = 10              # genotype's --kmer-thresh
RARE_WORTH = 3               # recruit.rs:28
MATCH_P, MATCH_Q = 1, 2      # match fraction 0.5: pairs and long reads
SHORT_CAP = 500              # single reads up to this long are short
MATCH_LEN = 2000             # genotype's -L/--match-len
STRETCH_MINIMS = -(-2 * MATCH_LEN // (W_MIN + 1))
STRETCH_SCORE = -(-max(STRETCH_MINIMS * (4 * MATCH_P - MATCH_Q),
                       3 * MATCH_Q) // MATCH_Q)
UNDEF = 1 << 32              # above every 32-bit hash
DIR_BW, DIR_FW, RARE_BIT = 1, 2, 4
NEG = -1e30


def _kmers(codes, k):
    """(canonical [B, P] int64, forward [B, P] bool, valid [B, P] bool) of
    every k-mer of the rows of `codes` [B, L] (codes >= 4 invalid)."""
    codes = codes.to(torch.int64)
    B, L = codes.shape
    P = L - k + 1
    ok = (codes >= 0) & (codes < 4)
    c = torch.where(ok, codes, 0)
    fw = torch.zeros((B, P), dtype=torch.int64, device=codes.device)
    rv = torch.zeros_like(fw)
    valid = torch.ones((B, P), dtype=torch.bool, device=codes.device)
    for j in range(k):
        cj = c[:, j:j + P]
        fw |= cj << (2 * (k - 1 - j))
        rv |= (3 - cj) << (2 * j)
        valid &= ok[:, j:j + P]
    is_fw = fw <= rv
    return torch.where(is_fw, fw, rv), is_fw, valid


def minimizers(codes, lens=None, k=K, w=W_MIN, bits=32):
    """(hash [B, P] int64, forward [B, P] bool, selected [B, P] bool).

    A position is selected when it holds the first least hash of some
    window of w k-mers.  With `lens`, only windows that lie inside a row's
    own k-mers count (a whole sequence); without, every window of the row
    counts (a read in a row padded with N).  `bits` < 32 keeps the low bits
    of the hash only."""
    kmer, is_fw, valid = _kmers(codes, k)
    x = ~kmer & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & 0xFFFFFFFF
    x ^= x >> 13
    if bits < 32:
        x &= (1 << bits) - 1
    h = torch.where(valid, x, UNDEF)
    B, P = h.shape
    if P < w:
        return h, is_fw, torch.zeros_like(valid)
    win = h.unfold(1, w, 1)                                 # [B, P-w+1, w]
    key = win * 16 + torch.arange(w, device=h.device)
    best = key.min(dim=2).values
    pos = (best & 15) + torch.arange(P - w + 1, device=h.device)
    take = (best >> 4) != UNDEF
    if lens is not None:
        m = (lens.to(torch.int64) - k + 1)[:, None]
        take &= torch.arange(P - w + 1, device=h.device)[None, :] + w - 1 < m
    sel = torch.zeros((B, P), dtype=torch.int32, device=h.device)
    sel.scatter_add_(1, pos, take.to(torch.int32))
    return h, is_fw, sel > 0


def _pad_rows(seqs, width, device):
    out = np.full((len(seqs), width), 4, np.int8)
    for i, s in enumerate(seqs):
        out[i, :s.size] = s
    return torch.from_numpy(out).to(device)


def genome_counts(genome, device):
    """Sorted unique canonical COUNT_K-mers of `genome` and their counts."""
    kmer, _, valid = _kmers(torch.from_numpy(genome[None, :]).to(device),
                            COUNT_K)
    return torch.unique(kmer[valid], return_counts=True)


def off_target_counts(gkeys, gcounts, hap, target, device):
    """Genome counts of every COUNT_K-mer of `hap`, less its occurrences
    in the locus's own stretch of the genome (`target`); invalid k-mers
    count as many."""
    kh, _, vh = _kmers(torch.from_numpy(hap[None, :]).to(device), COUNT_K)
    kh, vh = kh[0], vh[0]
    kt, _, vt = _kmers(torch.from_numpy(target[None, :]).to(device), COUNT_K)
    tkeys, tcounts = torch.unique(kt[0][vt[0]], return_counts=True)

    def look(keys, counts, q):
        i = torch.searchsorted(keys, q).clamp(max=max(keys.numel() - 1, 0))
        hit = keys[i] == q if keys.numel() else torch.zeros_like(q, dtype=bool)
        return torch.where(hit, counts[i], 0)

    g, t = look(gkeys, gcounts, kh), look(tkeys, tcounts, kh)
    c = torch.where(t > 0, (g - t).clamp(min=0), g)
    return torch.where(vh, c, 65535)


class RecruitIndex:
    """Every locus's minimizers with their strand bits and rare bit, as a
    dense table [keys, loci] of info bits (0 = the locus lacks the key)."""

    def __init__(self, loci, genome, starts, device, bits=32):
        self.names = [lc.name for lc in loci]
        self.bits = bits
        gkeys, gcounts = genome_counts(genome, device)
        key_parts, locus_parts, info_parts = [], [], []
        for li, (lc, start) in enumerate(zip(loci, starts)):
            target = genome[start:start + lc.haplotypes[0].size]
            seen = {}
            for hap in lc.haplotypes:         # add drops identical copies
                seen.setdefault(hap.tobytes(), hap)
            haps = list(seen.values())
            lens = torch.tensor([h.size for h in haps], device=device)
            h, is_fw, sel = minimizers(
                _pad_rows(haps, max(h.size for h in haps), device), lens,
                bits=bits)
            for r, hap in enumerate(haps):
                counts = off_target_counts(gkeys, gcounts, hap, target,
                                           device)
                pos = torch.nonzero(sel[r])[:, 0]
                shift = (COUNT_K - K) // 2
                ix = (pos - shift).clamp(0, counts.numel() - 1)
                rare = counts[ix] < RARE_BELOW
                key_parts.append(h[r, pos])
                locus_parts.append(torch.full_like(pos, li))
                info_parts.append(torch.where(is_fw[r, pos], DIR_FW, DIR_BW)
                                  | torch.where(rare, RARE_BIT, 0))
        keys = torch.cat(key_parts)
        loc = torch.cat(locus_parts)
        info = torch.cat(info_parts)
        n_loci = len(loci)
        ukeys, inv = torch.unique(keys, return_inverse=True)
        cell = inv * n_loci + loc
        # Strand bits: OR over occurrences; rare bit: AND over them.
        zeros = torch.zeros(ukeys.numel() * n_loci, dtype=torch.int64,
                            device=device)
        bw = zeros.clone().scatter_reduce_(0, cell, info & 1, "amax")
        fw = zeros.clone().scatter_reduce_(0, cell, info & 2, "amax")
        present = zeros.clone().scatter_reduce_(0, cell,
                                                torch.ones_like(info), "amax")
        rare = (zeros + 1).scatter_reduce_(0, cell, (info >> 2) & 1, "amin")
        table = (bw | fw | (rare * RARE_BIT)) * present
        self.keys = ukeys
        self.table = torch.cat([table.view(-1, n_loci).to(torch.uint8),
                                torch.zeros((1, n_loci), dtype=torch.uint8,
                                            device=device)])

    def counters(self, codes):
        """[B, loci, 4] counts (bw common, fw common, bw rare, fw rare) and
        [B] minimizer totals of reads in rows padded with N."""
        h, is_fw, sel = minimizers(codes, bits=self.bits)
        total = sel.sum(dim=1)
        S = int(total.max()) if total.numel() else 0
        order = torch.argsort((~sel).to(torch.uint8), dim=1, stable=True)
        order = order[:, :max(S, 1)]
        h, is_fw, sel = (torch.gather(t, 1, order) for t in (h, is_fw, sel))
        i = torch.searchsorted(self.keys, h).clamp(max=self.keys.numel() - 1)
        found = sel & (self.keys[i] == h)
        row = torch.where(found, i, self.keys.numel())
        info = self.table[row].to(torch.int64)              # [B, S, loci]
        f = is_fw[:, :, None]
        fw_hit = torch.where(f, info & DIR_FW, info & DIR_BW) != 0
        bw_hit = torch.where(f, info & DIR_BW, info & DIR_FW) != 0
        rare = (info & RARE_BIT) != 0
        c = torch.stack([(bw_hit & ~rare).sum(1), (fw_hit & ~rare).sum(1),
                         (bw_hit & rare).sum(1), (fw_hit & rare).sum(1)],
                        dim=2)
        return c, total

    def _hits(self, codes):
        """A row's selected minimizers in order: (fw_hit, bw_hit, rare,
        selected), each [B, S, loci] bool but `selected` [B, S], and the
        [B] minimizer totals."""
        h, is_fw, sel = minimizers(codes, bits=self.bits)
        total = sel.sum(dim=1)
        S = max(int(total.max()) if total.numel() else 0, 1)
        order = torch.argsort((~sel).to(torch.uint8), dim=1, stable=True)
        h, is_fw, sel = (torch.gather(t, 1, order[:, :S])
                         for t in (h, is_fw, sel))
        i = torch.searchsorted(self.keys, h).clamp(max=self.keys.numel() - 1)
        found = sel & (self.keys[i] == h)
        info = self.table[torch.where(found, i, self.keys.numel())] \
            .to(torch.int64)
        f = is_fw[:, :, None]
        fw_hit = torch.where(f, info & DIR_FW, info & DIR_BW) != 0
        bw_hit = torch.where(f, info & DIR_BW, info & DIR_FW) != 0
        return fw_hit, bw_hit, (info & RARE_BIT) != 0, sel, total

    def decide_short(self, codes):
        """[B, loci] bool: short single reads (recruit.rs:852-881)."""
        c, t = self.counters(codes)
        bw_c, fw_c, bw_r, fw_r = c.unbind(2)
        t = t[:, None]
        fw_n, bw_n = RARE_WORTH * fw_r + fw_c, RARE_WORTH * bw_r + bw_c
        use_fw = fw_n >= bw_n
        n = torch.where(use_fw, fw_n, bw_n)
        d = torch.where(use_fw, RARE_WORTH * (t - fw_c) + fw_c,
                        RARE_WORTH * (t - bw_c) + bw_c).clamp(min=1)
        return ((bw_r + fw_r) > 0) & (n * MATCH_Q >= MATCH_P * d)

    def decide_long(self, codes):
        """[B, loci] bool: long single reads (recruit.rs:966-997)."""
        fw_hit, bw_hit, rare, sel, total = self._hits(codes)
        fw_c, bw_c = (fw_hit & ~rare).sum(1), (bw_hit & ~rare).sum(1)
        fw_r, bw_r = (fw_hit & rare).sum(1), (bw_hit & rare).sum(1)
        use_fw = fw_r >= bw_r
        numer = torch.where(use_fw, fw_r, bw_r)
        denom = total[:, None] - torch.where(use_fw, fw_c, bw_c)
        m = denom.clamp(max=STRETCH_MINIMS)
        thresh = torch.div(m * MATCH_P + MATCH_Q - 1, MATCH_Q,
                           rounding_mode="floor").clamp(min=1)
        # The matching stretch, minimizer by minimizer (recruit.rs:940-964):
        # a hit adds 1, 3 more if rare; every minimizer takes 1; the sum
        # never falls below 0; the read passes once it reaches the score.
        x = 1 + 3 * rare.to(torch.int64)
        s_fw = torch.zeros_like(fw_c)
        s_bw = torch.zeros_like(fw_c)
        best = torch.zeros_like(fw_c)
        for j in range(sel.shape[1]):
            on = sel[:, j, None].to(torch.int64)
            s_fw = (s_fw + fw_hit[:, j] * x[:, j] - on).clamp(min=0)
            s_bw = (s_bw + bw_hit[:, j] * x[:, j] - on).clamp(min=0)
            best = torch.maximum(best, torch.maximum(s_fw, s_bw))
        stretch = (denom < STRETCH_MINIMS) | (best >= STRETCH_SCORE)
        return (numer >= thresh) & stretch

    def decide_pairs(self, codes1, codes2):
        """[B, loci] bool: the pair is recruited to the locus."""
        a, t1 = self.counters(codes1)
        b, t2 = self.counters(codes2)
        t1, t2 = t1[:, None], t2[:, None]
        bw_c1, fw_c1, bw_r1, fw_r1 = a.unbind(2)
        bw_c2, fw_c2, bw_r2, fw_r2 = b.unbind(2)
        fw_n1, bw_n1 = RARE_WORTH * fw_r1 + fw_c1, RARE_WORTH * bw_r1 + bw_c1
        fw_n2, bw_n2 = RARE_WORTH * fw_r2 + fw_c2, RARE_WORTH * bw_r2 + bw_c2
        fw_d1 = (RARE_WORTH * (t1 - fw_c1) + fw_c1).clamp(min=1)
        bw_d1 = (RARE_WORTH * (t1 - bw_c1) + bw_c1).clamp(min=1)
        fw_d2 = (RARE_WORTH * (t2 - fw_c2) + fw_c2).clamp(min=1)
        bw_d2 = (RARE_WORTH * (t2 - bw_c2) + bw_c2).clamp(min=1)
        use_fw = fw_n1 + bw_n2 >= bw_n1 + fw_n2
        n1 = torch.where(use_fw, fw_n1, bw_n1)
        d1 = torch.where(use_fw, fw_d1, bw_d1)
        n2 = torch.where(use_fw, bw_n2, fw_n2)
        d2 = torch.where(use_fw, bw_d2, fw_d2)
        ok = (n1 * MATCH_Q >= MATCH_P * d1) & (n2 * MATCH_Q >= MATCH_P * d2)
        rare = (bw_r1 + fw_r1 + bw_r2 + fw_r2) > 0
        # Only loci that mate 1 hits are candidates (recruit.rs:915-917).
        return ok & rare & (a.sum(2) > 0)


def _single_rows(reads):
    """[(row width, read indices)]: reads over SHORT_CAP bases by
    power-of-two length class from 1,024, the rest together at the next
    multiple of 64 of the longest."""
    groups = {}
    for i, r in enumerate(reads):
        if r.size > SHORT_CAP:
            width = 1024
            while width < r.size:
                width *= 2
        else:
            width = 0
        groups.setdefault(width, []).append(i)
    if 0 in groups:
        short = groups.pop(0)
        groups[-(-max(reads[i].size for i in short) // 64) * 64] = short
    return sorted(groups.items())


def recruit_single(index: RecruitIndex, names, reads, codes_a_block=1 << 21):
    """{locus: set of read names} for single reads, in blocks of about
    `codes_a_block` codes."""
    dev = index.keys.device
    out = {n: set() for n in index.names}
    for width, rows in _single_rows(reads):
        decide = index.decide_long if width > SHORT_CAP \
            else index.decide_short
        step = max(codes_a_block // width, 1)
        for s in range(0, len(rows), step):
            part = rows[s:s + step]
            hits = torch.nonzero(decide(_pad_rows(
                [reads[i] for i in part], width, dev))).cpu().numpy()
            for r, li in hits:
                out[index.names[li]].add(names[part[r]])
    return out


def recruit(index: RecruitIndex, names, mates1, mates2, flank=None,
            block=16384):
    """{locus: set of pair names} for the pairs (names, mates1, mates2) and
    the flank pairs `flank` = (names, [N, L] mates 1, [N, L] mates 2)."""
    dev = index.keys.device
    out = {n: set() for n in index.names}
    width = max([s.size for s in mates1 + mates2]
                + [150 if flank is None else flank[1].shape[1]]) + W_MIN

    def run(nms, m1, m2):
        hits = torch.nonzero(index.decide_pairs(m1, m2)).cpu().numpy()
        for r, li in hits:
            out[index.names[li]].add(nms[r])

    for s in range(0, len(names), block):
        run(names[s:s + block], _pad_rows(mates1[s:s + block], width, dev),
            _pad_rows(mates2[s:s + block], width, dev))
    if flank is not None:
        fn, f1, f2 = flank
        pad = np.full((f1.shape[0], width - f1.shape[1]), 4, np.int8)
        for s in range(0, f1.shape[0], block):
            run(fn[s:s + block],
                *(torch.from_numpy(np.concatenate([m[s:s + block],
                                                   pad[s:s + block]], 1))
                  .to(dev) for m in (f1, f2)))
    return out


# -- the banded aligner ------------------------------------------------------

_PAY_MISM, _PAY_INS, _PAY_DEL, _PAY_CLIP, _PAY_START = range(5)


def align(reads, rlens, hap_wins, score_vec, band, max_del_run=32,
          dtype=torch.float32):
    """Frozen copy of the port's `align_batch_reference`: banded
    maximum-likelihood alignment of reads [N, L] against windows
    [N, L + band], deletion runs capped at min(max_del_run, band) by a
    doubling scan that takes strictly greater values only.  `dtype` is the
    arithmetic's precision."""
    N, L = reads.shape
    dev = reads.device
    f32, i32 = dtype, torch.int32
    sv = score_vec.to(device=dev, dtype=f32)
    m_sc, x_sc, i_sc, d_sc, c_sc = (sv[k] for k in range(5))
    lens = rlens.to(i32)[:, None]
    lens_f = lens.to(f32)
    j_idx = torch.arange(band, dtype=i32, device=dev)[None, :]
    jd = j_idx.to(f32) * d_sc
    mdr = min(int(max_del_run), band)

    prev = torch.zeros((N, band), dtype=f32, device=dev)
    pay = torch.zeros((5, N, band), dtype=i32, device=dev)
    pay[_PAY_START] = j_idx
    best_s = torch.full((N,), NEG, dtype=f32, device=dev)
    best_pay = torch.zeros((5, N), dtype=i32, device=dev)
    best_ep = torch.zeros((N,), dtype=i32, device=dev)
    neg_col = torch.full((N, 1), NEG, dtype=f32, device=dev)
    clip_pay = torch.zeros((5, 1, band), dtype=i32, device=dev)
    reads = reads.to(torch.int8)
    hap_wins = hap_wins.to(torch.int8)

    n_rows = min(L, int(rlens.max())) if N else 0
    for i in range(1, n_rows + 1):
        r_c = reads[:, i - 1:i]
        h_c = hap_wins[:, i - 1:i - 1 + band]
        sub = torch.where(r_c == h_c, m_sc, x_sc)
        sub = torch.where((h_c < 4) & (r_c < 4), sub,
                          torch.tensor(NEG, dtype=f32, device=dev))
        diag_s = prev + sub
        d_pay = pay.clone()
        d_pay[_PAY_MISM] += (r_c != h_c).to(i32)

        ins_s = torch.cat([prev[:, 1:], neg_col], dim=1) + i_sc
        ins_s[:, band - 1] = NEG
        i_pay = torch.roll(pay, -1, dims=2)
        i_pay[_PAY_INS] += 1

        clip_s = c_sc * float(i)
        take_i = ins_s > diag_s
        base_s = torch.where(take_i, ins_s, diag_s)
        b_pay = torch.where(take_i[None], i_pay, d_pay)
        take_c = clip_s > base_s
        base_s = torch.where(take_c, clip_s, base_s)
        clip_pay[_PAY_CLIP] = i
        clip_pay[_PAY_START] = i + j_idx
        b_pay = torch.where(take_c[None], clip_pay, b_pay)

        adj = base_s - jd
        orig = j_idx.expand(N, band)
        s = 1
        while s < mdr:
            sh_adj = torch.cat([neg_col.expand(N, s), adj[:, :-s]], dim=1)
            take = sh_adj > adj
            adj = torch.where(take, sh_adj, adj)
            orig = torch.where(take, torch.roll(orig, s, dims=1), orig)
            s *= 2
        row_s = torch.where(orig == j_idx, base_s, adj + jd)
        pay = torch.gather(b_pay, 2,
                           orig.to(torch.int64)[None].expand(5, N, band))
        pay[_PAY_DEL] += j_idx - orig

        active = lens >= i
        end_bonus = torch.where(active, (lens_f - float(i)) * c_sc,
                                torch.tensor(NEG, dtype=f32, device=dev))
        cand = row_s + end_bonus
        cand_max = cand.max(dim=1).values
        key = torch.where(cand == cand_max[:, None], band - j_idx, 0)
        jbest = key.argmax(dim=1)
        better = cand_max > best_s
        best_s = torch.where(better, cand_max, best_s)
        picked = pay[:, torch.arange(N, device=dev), jbest]
        picked[_PAY_CLIP] += lens[:, 0] - i
        best_pay = torch.where(better[None], picked, best_pay)
        best_ep = torch.where(better, (i + jbest).to(i32), best_ep)
        prev = torch.where(active, row_s,
                           torch.tensor(NEG, dtype=f32, device=dev))

    return dict(score=best_s.float(), start_p=best_pay[_PAY_START],
                end_p=best_ep, n_mism=best_pay[_PAY_MISM],
                n_ins=best_pay[_PAY_INS], n_del=best_pay[_PAY_DEL],
                n_clip=best_pay[_PAY_CLIP])


# -- the annealer's end state ------------------------------------------------

def chain_likelihood(probs, winpk, wtab, assgn, dc, ac, dtype=torch.float64):
    """ln-likelihood of chains in the state `assgn` [C, R]: ac x the sum of
    the assigned candidates' ln-probabilities (probs [C, R, K]) + dc x the
    sum over windows of the window table (wtab [C, W, D]) at the window's
    depth, the number of read ends the assignment puts in it (winpk packs
    two window indices a candidate, 16 bits each), held at D - 1."""
    C, R, _ = probs.shape
    Wn, D = wtab.shape[1], wtab.shape[2]
    a = assgn.long()[:, :, None]
    wp = torch.gather(winpk.long(), 2, a)[:, :, 0]
    depth = torch.zeros((C, Wn), dtype=torch.int64, device=probs.device)
    ones = torch.ones_like(wp)
    depth.scatter_add_(1, wp & 0xFFFF, ones)
    depth.scatter_add_(1, (wp >> 16) & 0xFFFF, ones)
    tab = torch.gather(wtab, 2, depth.clamp(max=D - 1)[:, :, None])[:, :, 0]
    aln = torch.gather(probs, 2, a)[:, :, 0]
    return dc * tab.to(dtype).sum(1) + ac * aln.to(dtype).sum(1)


def best_move_gain(probs, winpk, wtab, assgn, dc, ac):
    """[C] float64: the most by which moving one read of each chain to
    another of its valid candidates (ln-probability above NEG / 2) raises
    the likelihood `chain_likelihood` gives the state `assgn`; -inf where
    no read has a second candidate.  A move takes a read end out of each
    window of its current candidate and puts one into each window of the
    new one; a window named more than once counts its net change once."""
    C, R, K = probs.shape
    D = wtab.shape[2]
    dev = probs.device
    best = torch.full((C,), -np.inf, dtype=torch.float64, device=dev)
    a = assgn.long()
    other = (probs > NEG / 2) & (torch.arange(K, device=dev) != a[:, :, None])
    c, r, k = torch.nonzero(other, as_tuple=True)
    if c.numel() == 0:
        return best
    wp = winpk.long()
    wp_now = torch.gather(wp, 2, a[:, :, None])[:, :, 0]
    depth = torch.zeros((C, wtab.shape[1]), dtype=torch.int64, device=dev)
    ones = torch.ones_like(wp_now)
    depth.scatter_add_(1, wp_now & 0xFFFF, ones)
    depth.scatter_add_(1, (wp_now >> 16) & 0xFFFF, ones)
    cur = a[c, r]
    w_cur, w_new = wp[c, r, cur], wp[c, r, k]
    ws = torch.stack([w_cur & 0xFFFF, (w_cur >> 16) & 0xFFFF,
                      w_new & 0xFFFF, (w_new >> 16) & 0xFFFF], 1)  # [M, 4]
    step = torch.tensor([-1, -1, 1, 1], device=dev)
    same = ws[:, :, None] == ws[:, None, :]
    net = (same * step).sum(2)
    earlier = torch.ones((4, 4), dtype=torch.bool, device=dev).tril(-1)
    first = ~(same & earlier).any(2)
    cc = c[:, None].expand(-1, 4)
    d = depth[cc, ws]
    tab = wtab.double()
    change = tab[cc, ws, (d + net).clamp(0, D - 1)] \
        - tab[cc, ws, d.clamp(max=D - 1)]
    dd = torch.where(first & (net != 0), change, 0.0).sum(1)
    p = probs.double()
    gain = dc * dd + ac * (p[c, r, k] - p[c, r, cur])
    return best.scatter_reduce_(0, c, gain, "amax")
