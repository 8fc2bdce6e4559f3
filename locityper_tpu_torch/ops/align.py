"""Banded maximum-likelihood read↔haplotype alignment on device.

This kernel replaces three external components of the reference
(SURVEY.md §2.2): the strobealign/minimap2 subprocess mappers
(command/genotype.rs:978-1074), the WFA2-lib C aligner (seq/wfa.rs), and the
alignment-transfer machinery (seq/transfer.rs, cigar.rs:944-1035) — by
densely aligning every recruited read against every candidate haplotype
window in one batched call.

Model: the DP directly maximizes the *error-profile log-likelihood* of the
alignment — each op costs its background ln-probability (bg/err_prof.rs:212-221):
    =:ln p_match  X:ln p_mism  I:ln p_ins  D:ln p_del  S:ln p_clip
so the optimal score IS the alignment ln-prob used by the genotyping model
(model/locs.rs:299-305), and no separate CIGAR scoring pass is needed.
Gap model is linear (the multinomial error profile has no open/extend split).

Band parameterization: offset j ∈ [0, B) maps "read prefix i consumed" to
"haplotype-window prefix p = i + j consumed".  Moves:
    diag  (i-1, j)   + sub(r[i-1], h[i+j-1])
    ins   (i-1, j+1) + ins_score
    del   (i,   j-1) + del_score          (within-row max-plus scan, runs
                                           capped at max_del_run)
    clip-start: i·clip_score at any j     (soft-clip of the read head)
Row 0 is free (glocal start anywhere in the window).  Final score folds
max_i max_j S[i,j] + (len-i)·clip_score (soft-clip of the read tail).

Op counts (mismatch/ins/del/clip + start/end haplotype positions) ride along
as argmax payloads, giving edit distance and alignment intervals without
traceback (SURVEY.md §7 'CIGAR production').

Two implementations of the same function live here:

* `align_batch_reference` — plain PyTorch, vectorised over jobs with a
  Python loop over read rows.  Used by the tests, by `device="cpu"`, and as
  the yardstick the CUDA kernel is held against on the card.
* the CUDA kernel `ops/csrc/align_banded.cu`, launched by `align_banded`
  for tensors that lie on a CUDA device.

Both follow the reference package's Pallas kernel
(`locityper_tpu/ops/align_pallas.py:_kernel`): deletion runs capped at
`min(max_del_run, band)` by a doubling scan that takes strictly greater
values only, every multiply followed by a separately rounded add.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import _kernels

NEG = -1e30
MAX_BAND = 256       # the CUDA kernel keeps at most 8 band cells per lane


@dataclass(frozen=True)
class Scores:
    """Per-op ln-probabilities (see bg/err_prof.rs:88-110)."""
    match: float
    mismatch: float
    insertion: float
    deletion: float
    clip: float

    @classmethod
    def from_error_rates(cls, mism: float, ins: float, dele: float) -> "Scores":
        m = 1.0 - mism - ins - dele
        return cls(np.log(m), np.log(mism), np.log(ins), np.log(dele),
                   np.log(max(mism, ins)))

    def astuple(self):
        return (self.match, self.mismatch, self.insertion, self.deletion, self.clip)


#: Result keys of `align_batch`, in the order model/locs.py consumes them.
ALIGN_RESULT_KEYS = ("score", "start_p", "end_p", "n_mism", "n_ins",
                     "n_del", "n_clip", "valid")

# Payload channel order of the [5, N, band] tensor in the plain version and
# of the kernel's [6, N] integer output (end_p appended).
_PAY_MISM, _PAY_INS, _PAY_DEL, _PAY_CLIP, _PAY_START = range(5)


def align_batch_reference(reads, rlens, hap_wins, score_vec, band: int,
                          max_del_run: int = 32) -> dict:
    """Plain PyTorch version of the banded aligner (any device).

    reads [N, L] int8 codes 0-4 (pad 4), rlens [N] int32, hap_wins
    [N, L+band] int8, score_vec [5] f32 (match, mism, ins, del, clip).
    Returns a dict of [N] tensors keyed by ALIGN_RESULT_KEYS.

    Rows past the longest read are skipped: with ln-probability scores
    (all <= 0) an inactive row can never beat the best end found so far,
    so the outputs equal those of a full walk over all L rows."""
    N, L = reads.shape
    dev = reads.device
    f32, i32 = torch.float32, torch.int32
    sv = score_vec.to(device=dev, dtype=f32)
    m_sc, x_sc, i_sc, d_sc, c_sc = (sv[k] for k in range(5))
    lens = rlens.to(i32)[:, None]                               # [N, 1]
    lens_f = lens.to(f32)
    j_idx = torch.arange(band, dtype=i32, device=dev)[None, :]  # [1, band]
    jd = j_idx.to(f32) * d_sc                                   # j·del
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
        r_c = reads[:, i - 1:i]                                 # [N, 1]
        h_c = hap_wins[:, i - 1:i - 1 + band]                   # [N, band]
        sub = torch.where(r_c == h_c, m_sc, x_sc)
        sub = torch.where((h_c < 4) & (r_c < 4), sub, NEG)
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

        # Deletion max-plus scan: doubling steps, strict '>' so that ties
        # keep the nearer origin; payloads follow the winning origin.
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
        pay = torch.gather(b_pay, 2, orig.to(torch.int64)[None].expand(5, N, band))
        pay[_PAY_DEL] += j_idx - orig

        active = lens >= i
        end_bonus = torch.where(active, (lens_f - float(i)) * c_sc, NEG)
        cand = row_s + end_bonus
        cand_max = cand.max(dim=1).values
        # Smallest j among the row's maxima.
        key = torch.where(cand == cand_max[:, None], band - j_idx, 0)
        jbest = key.argmax(dim=1)
        better = cand_max > best_s
        best_s = torch.where(better, cand_max, best_s)
        picked = pay[:, torch.arange(N, device=dev), jbest]     # [5, N]
        picked[_PAY_CLIP] += lens[:, 0] - i
        best_pay = torch.where(better[None], picked, best_pay)
        best_ep = torch.where(better, (i + jbest).to(i32), best_ep)
        prev = torch.where(active, row_s, NEG)

    return dict(score=best_s, start_p=best_pay[_PAY_START], end_p=best_ep,
                n_mism=best_pay[_PAY_MISM], n_ins=best_pay[_PAY_INS],
                n_del=best_pay[_PAY_DEL], n_clip=best_pay[_PAY_CLIP],
                valid=best_s > NEG / 2)


def _align_banded_cuda(reads, rlens, hap_wins, score_vec, band: int,
                       max_del_run: int) -> dict:
    """Launches the CUDA kernel on tensors that lie on one CUDA device."""
    N, L = reads.shape
    if band < 1 or band > MAX_BAND:
        raise ValueError(f"band {band} outside the kernel's range 1..{MAX_BAND}")
    for name, t, dt in (("reads", reads, torch.int8), ("rlens", rlens, torch.int32),
                        ("hap_wins", hap_wins, torch.int8),
                        ("score_vec", score_vec, torch.float32)):
        if t.dtype != dt or not t.is_cuda or t.device != reads.device:
            raise ValueError(f"{name}: expected {dt} on {reads.device}, got "
                             f"{t.dtype} on {t.device}")
    if hap_wins.shape != (N, L + band) or rlens.shape != (N,) \
            or score_vec.shape != (5,):
        raise ValueError("align_banded: inconsistent shapes "
                         f"{tuple(reads.shape)} {tuple(rlens.shape)} "
                         f"{tuple(hap_wins.shape)} {tuple(score_vec.shape)}")
    reads, rlens, hap_wins, score_vec = (
        t.contiguous() for t in (reads, rlens, hap_wins, score_vec))
    score = torch.empty((N,), dtype=torch.float32, device=reads.device)
    ints = torch.empty((6, N), dtype=torch.int32, device=reads.device)
    if N:
        lib = _kernels.load()
        with torch.cuda.device(reads.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.align_banded_launch(
                reads.data_ptr(), rlens.data_ptr(), hap_wins.data_ptr(),
                score_vec.data_ptr(), score.data_ptr(), ints.data_ptr(),
                N, L, band, min(int(max_del_run), band), stream)
        _kernels.check(err, "align_banded")
        _kernels.LAUNCHES["align_banded"] += 1
    return dict(score=score, start_p=ints[_PAY_START], end_p=ints[5],
                n_mism=ints[_PAY_MISM], n_ins=ints[_PAY_INS],
                n_del=ints[_PAY_DEL], n_clip=ints[_PAY_CLIP],
                valid=score > NEG / 2)


def align_banded(reads, rlens, hap_wins, score_vec, band: int = 48,
                 max_del_run: int = 32) -> dict:
    """Kernel wrapper: CUDA tensors go to the hand-written kernel (or
    raise), CPU tensors to the plain version — decided by where `reads`
    lies and by nothing else."""
    if reads.is_cuda:
        return _align_banded_cuda(reads, rlens, hap_wins, score_vec, band,
                                  max_del_run)
    return align_batch_reference(reads, rlens, hap_wins, score_vec, band,
                                 max_del_run)


def align_batch(reads, rlens, hap_wins, score_vec, band: int = 48,
                max_del_run: int = 32, device=None) -> dict:
    """Batched banded alignment, any N and any L.

    reads:    [N, L]        int8
    rlens:    [N]           int32
    hap_wins: [N, L+band]   int8 (the haplotype's window at the candidate
                            diagonal, pad 4 outside the haplotype)
    score_vec: [5] f32      (match, mism, ins, del, clip) ln-probs
    device: None = CUDA (raises without one); "cpu" = plain PyTorch version.
    Inputs may be numpy arrays or tensors; returns a dict of [N] tensors on
    `device`.
    """
    dev = _kernels.resolve_device(device)
    reads, rlens, hap_wins, score_vec = (
        torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
        for x in (reads, rlens, hap_wins, score_vec))
    return align_banded(reads.to(dev, torch.int8), rlens.to(dev, torch.int32),
                        hap_wins.to(dev, torch.int8),
                        score_vec.to(dev, torch.float32), band, max_del_run)


# ---------------------------------------------------------------------------
# Host-side helpers: candidate windows and batched invocation.
# ---------------------------------------------------------------------------

def extract_windows(hap: np.ndarray, win_starts: np.ndarray, width: int) -> np.ndarray:
    """Gathers [len(win_starts), width] windows from a haplotype, padding
    out-of-range positions with code 4 (vectorized gather, no per-row
    Python)."""
    n = win_starts.size
    if n == 0:
        return np.full((0, width), 4, dtype=np.int8)
    idx = win_starts.astype(np.int64)[:, None] + np.arange(width)[None, :]
    # Clamp to a sentinel slot holding code 4 on both ends.
    np.clip(idx, -1, hap.size, out=idx)
    padded = np.full(hap.size + 2, 4, dtype=np.int8)
    padded[1:-1] = hap
    return padded[idx + 1]


def edit_and_matches(res: dict, rlens: np.ndarray):
    """Vector (edit, matches) per alignment, following err_prof.rs:71-80:
    matches = rlen - mism - ins - clip;  edit = mism + ins + clip + del."""
    n_mism = np.asarray(res["n_mism"])
    n_ins = np.asarray(res["n_ins"])
    n_del = np.asarray(res["n_del"])
    n_clip = np.asarray(res["n_clip"])
    matches = rlens - n_mism - n_ins - n_clip
    edit = n_mism + n_ins + n_clip + n_del
    return edit, matches
