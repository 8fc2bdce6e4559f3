"""Device recruitment: batched minimizer matching on the GPU.

The device twin of seq/recruit.py's host engine (behavioral spec:
reference seq/recruit.rs): dense [B, L] read batches → canonical k-mers →
32-bit murmur3 minimizers (first-argmin per window) → sorted-table binary
search → per-locus direction/rarity counters → short-read, pair and
long-read decision rules, bit-identical to the host path.

Index layout: instead of variable-length (locus, info) entry lists (a
scatter-heavy shape), each minimizer key stores three LOCUS BITMAPS
(fw-direction, bw-direction, rare) as 32-bit words (32 loci per word).
Per-locus counters then reduce to bit-extractions + sums, with no scatters
and no per-entry loop (SURVEY.md §7 'device hash tables').

Decision rules are exact integer cross-multiplications of the rational
match-fraction threshold.

The front end — k-mers, hashes, minimizer mask and the compaction of the
first S minimizers of each read — is one function with two implementations:

* `minimizer_front_reference` — plain PyTorch.  Used by the tests, by
  `device="cpu"`, and as the yardstick the CUDA kernel is held against.
* the CUDA kernel `ops/csrc/minimizer_front.cu`, launched by
  `minimizer_front` for tensors that lie on a CUDA device; it replaces the
  reference package's `_front_compact_pallas` (with `S`) and
  `_hash_mask_pallas` (without).

Everything after the front end (the table lookup, the bit extraction, the
decision rules) is plain PyTorch on the batch's device, as it is plain XLA
in the reference package.  32-bit hash words travel as int32 bit patterns:
hashes in the SIGNED order-preserving view (h ^ 0x80000000), so that the
sorted-key binary search orders them like the unsigned hashes; table rows as
the raw bits.
"""
from __future__ import annotations

from collections import namedtuple
from dataclasses import dataclass

import numpy as np
import torch

from .. import _kernels
from ..utils import spans
from ..seq.recruit import (DIR_BW, DIR_FW, RARE_BIT, RARE_WORTH,
                           SUBSUM_BONUS, SUBSUM_PENALTY, TargetIndex)

SIGN_BIT = 0x80000000
BIG_S32 = 0x7FFFFFFF                    # the undefined hash, signed view
_I32_MIN = -0x80000000                  # SIGN_BIT as an int32 bit pattern
MAX_K = 16                              # 32-bit k-mers in 32-bit words
MAX_W = 1024                            # halo of w - 1 a chunk: 35 KB a warp

_Cfg = namedtuple("_Cfg", "n_loci n_groups k w frac_p frac_q")


@dataclass(frozen=True, eq=False)
class DeviceIndex:
    """TargetIndex as per-key locus bitmaps (sorted-key lookup)."""
    keys: np.ndarray          # [M] uint32 sorted
    fw_mask: np.ndarray       # [M, G] uint32 — direction includes forward
    bw_mask: np.ndarray       # [M, G] uint32 — direction includes backward
    rare_mask: np.ndarray     # [M, G] uint32
    n_loci: int
    n_groups: int
    k: int
    w: int
    frac_p: int               # match_frac = frac_p / frac_q
    frac_q: int

    @classmethod
    def from_index(cls, index: TargetIndex) -> "DeviceIndex":
        p = index.params
        frac = p.match_frac_rational
        M = index.keys.size
        G = max(-(-index.n_loci // 32), 1)
        key_of = np.repeat(np.arange(M), np.diff(index.offsets))
        locus = index.entry_locus.astype(np.int64)
        info = index.entry_info
        bit = np.uint32(1) << (locus % 32).astype(np.uint32)
        masks = []
        for flag in (DIR_FW, DIR_BW, RARE_BIT):
            m = np.zeros((M, G), np.uint32)
            sel = (info & flag) != 0
            np.bitwise_or.at(m, (key_of[sel], locus[sel] // 32), bit[sel])
            masks.append(m)
        return cls(keys=index.keys.astype(np.uint32), fw_mask=masks[0],
                   bw_mask=masks[1], rare_mask=masks[2], n_loci=index.n_loci,
                   n_groups=G, k=p.minimizer_k, w=p.minimizer_w,
                   frac_p=frac.numerator, frac_q=frac.denominator)

    @property
    def packed(self) -> np.ndarray:
        """[M, 1+3G] uint32: key + fw/bw/rare bitmaps in ONE row — key
        verification and all three bitmaps cost a single row gather."""
        if not hasattr(self, "_packed"):
            object.__setattr__(self, "_packed", np.concatenate(
                [self.keys[:, None], self.fw_mask, self.bw_mask,
                 self.rare_mask], axis=1).astype(np.uint32))
        return self._packed

    @property
    def cfg(self) -> "_Cfg":
        return _Cfg(self.n_loci, self.n_groups, self.k, self.w,
                    self.frac_p, self.frac_q)

    @property
    def keys_signed(self) -> np.ndarray:
        """Sorted keys in the signed order-preserving view (see SIGN_BIT)."""
        return (self.keys ^ np.uint32(SIGN_BIT)).astype(np.int32)

    def device_args(self, device):
        """(keys_signed [M] int32, packed [M, 1+3G] as int32 bit patterns)
        resident on `device`, uploaded once per device."""
        if not hasattr(self, "_dev_args"):
            object.__setattr__(self, "_dev_args", {})
        dev = torch.device(device)
        if dev not in self._dev_args:
            self._dev_args[dev] = (
                torch.from_numpy(self.keys_signed).to(dev),
                torch.from_numpy(self.packed.view(np.int32)).to(dev))
        return self._dev_args[dev]


def _front_S(P: int, w: int) -> int:
    """Columns kept by the compaction.  The expected per-read minimizer
    count is 2P/(w+1); the cap is >2.5x that mean, so by a Chernoff bound
    the truncation probability per read is < 1e-9 (and truncation only
    DROPS matches — strictly conservative for recruitment)."""
    return min(P, max(4 * (P // (w + 1)) + 16, 16))


def _check_front_args(reads, k: int, w: int, S):
    if reads.dim() != 2 or reads.dtype != torch.int8:
        raise ValueError(f"minimizer_front: expected [B, L] int8 codes, got "
                         f"{tuple(reads.shape)} {reads.dtype}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"minimizer_front requires 1 <= k <= {MAX_K} "
                         f"(2k-bit k-mers in 32-bit words), got {k}")
    if not 1 <= w <= MAX_W:
        raise ValueError(f"minimizer_front requires 1 <= w <= {MAX_W}, got {w}")
    if reads.shape[1] < k:
        raise ValueError(f"minimizer_front: rows of {reads.shape[1]} codes "
                         f"hold no {k}-mer")
    if S is not None and S < 1:
        raise ValueError(f"minimizer_front: S must be positive, got {S}")


def _hash_mask_reference(reads, k: int, w: int):
    """(hs [B, P] int32 signed view, is_fw [B, P] bool, mask [B, P] bool):
    every position's canonical k-mer hash (BIG_S32 where a code is invalid)
    and whether the position is the first argmin of some window of w.

    32-bit unsigned arithmetic is done in int64 and masked: PyTorch's `>>` on
    int32 is arithmetic and its uint32 support is partial."""
    B, L = reads.shape
    P = L - k + 1
    i64 = torch.int64
    codes = reads.to(i64)
    valid = (codes >= 0) & (codes < 4)
    c = torch.where(valid, codes, 0)
    fw = torch.zeros((B, P), dtype=i64, device=reads.device)
    rv = torch.zeros((B, P), dtype=i64, device=reads.device)
    ok = torch.ones((B, P), dtype=torch.bool, device=reads.device)
    for j in range(k):
        cj = c[:, j:j + P]
        fw |= cj << (2 * (k - 1 - j))
        rv |= (3 - cj) << (2 * j)
        ok &= valid[:, j:j + P]
    is_fw = fw <= rv
    x = ~torch.where(is_fw, fw, rv) & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & 0xFFFFFFFF
    x ^= x >> 13
    # int32(x ^ 0x80000000) is x - 2^31.
    hs = torch.where(ok, x - SIGN_BIT, BIG_S32)

    # Position p is selected by SOME window iff a' + b' >= w-1, where a' =
    # number of consecutive left neighbours with strictly greater hash (ties
    # break to the first index) and b' = consecutive right neighbours with
    # greater-or-equal hash, both capped by the array edges and w-1.
    a = torch.zeros((B, P), dtype=i64, device=reads.device)
    b = torch.zeros((B, P), dtype=i64, device=reads.device)
    lmin = rmin = None
    # Neighbours past the row's edges count as undefined (greater).
    for i in range(1, w):
        sh_l = torch.full_like(hs, BIG_S32)
        sh_r = torch.full_like(hs, BIG_S32)
        if i < P:
            sh_l[:, i:] = hs[:, :P - i]
            sh_r[:, :P - i] = hs[:, i:]
        lmin = sh_l if lmin is None else torch.minimum(lmin, sh_l)
        a += lmin > hs
        rmin = sh_r if rmin is None else torch.minimum(rmin, sh_r)
        b += rmin >= hs
    pos = torch.arange(P, dtype=i64, device=reads.device)[None, :]
    a = torch.minimum(a, pos)
    b = torch.minimum(b, P - 1 - pos)
    mask = (a + b >= w - 1) & (hs != BIG_S32)
    return hs.to(torch.int32), is_fw, mask


def minimizer_front_reference(reads, k: int, w: int, S: int | None = None):
    """Plain PyTorch version of the minimizer front end (any device).

    reads [B, L] int8 codes (0-3 bases, anything else invalid).  With
    `S=None` returns (hs [B, P] int32, is_fw [B, P] bool, mask [B, P] bool)
    for all P = L-k+1 positions.  With `S` returns (hs [B, S], is_fw [B, S],
    mask [B, S], total [B] int32): the first S minimizer positions of each
    read packed to the front in position order, columns past a read's count
    holding (BIG_S32, False, False), and `total` the read's whole count."""
    _check_front_args(reads, k, w, S)
    hs, is_fw, mask = _hash_mask_reference(reads, k, w)
    if S is None:
        return hs, is_fw, mask
    total = mask.sum(dim=1).to(torch.int32)
    P = hs.shape[1]
    order = torch.argsort((~mask).to(torch.uint8), dim=1, stable=True)
    order = order[:, :min(S, P)]
    hs, is_fw, mask = (torch.gather(t, 1, order) for t in (hs, is_fw, mask))
    if S > P:
        pad = (0, S - P)
        hs, is_fw, mask = (torch.nn.functional.pad(t, pad)
                           for t in (hs, is_fw, mask))
    hs = torch.where(mask, hs, BIG_S32)
    return hs, is_fw & mask, mask, total


def _minimizer_front_cuda(reads, k: int, w: int, S):
    """Launches the CUDA kernel on a tensor that lies on a CUDA device."""
    reads = reads.contiguous()
    B, L = reads.shape
    P = L - k + 1
    dev = reads.device
    cols = P if S is None else S
    hs = torch.empty((B, cols), dtype=torch.int32, device=dev)
    is_fw = torch.empty((B, cols), dtype=torch.bool, device=dev)
    mask = torch.empty((B, cols), dtype=torch.bool, device=dev)
    total = None if S is None else torch.empty((B,), dtype=torch.int32,
                                               device=dev)
    if B:
        lib = _kernels.load()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            if S is None:
                name = "minimizer_front_full"
                err = lib.minimizer_front_full_launch(
                    reads.data_ptr(), hs.data_ptr(), is_fw.data_ptr(),
                    mask.data_ptr(), B, L, k, w, stream)
            else:
                name = "minimizer_front_compact"
                err = lib.minimizer_front_compact_launch(
                    reads.data_ptr(), hs.data_ptr(), is_fw.data_ptr(),
                    mask.data_ptr(), total.data_ptr(), B, L, k, w, S, stream)
        _kernels.check(err, name)
        _kernels.LAUNCHES[name] += 1
    if S is None:
        return hs, is_fw, mask
    return hs, is_fw, mask, total


def minimizer_front(reads, k: int, w: int, S: int | None = None):
    """Kernel wrapper: a CUDA tensor goes to the hand-written kernel (or
    raises), a CPU tensor to the plain version — decided by where `reads`
    lies and by nothing else.  See `minimizer_front_reference`.  The rows
    of every compacting call (K3) are added to the open call's counter
    `k3_rows`, on either device."""
    if S is not None:
        spans.count("k3_rows", reads.shape[0])
    if reads.is_cuda:
        _check_front_args(reads, k, w, S)
        return _minimizer_front_cuda(reads, k, w, S)
    return minimizer_front_reference(reads, k, w, S)


def _lookup_rows(cfg: _Cfg, h, mask, keys_signed, packed):
    """(found [B, S] bool, rows [B, S, 1+3G] int32 bit patterns): one packed
    index row per minimizer query — key verification and all three bitmaps
    ride ONE row gather.  Binary search over the signed-view sorted keys;
    undefined hashes (BIG_S32) land past the end and are clamped."""
    M = keys_signed.shape[0]
    if M == 0:
        rows = torch.zeros(h.shape + (packed.shape[1],), dtype=torch.int32,
                           device=h.device)
        return torch.zeros_like(mask), rows
    idx = torch.searchsorted(keys_signed, h.reshape(-1))
    idx.clamp_(max=M - 1)
    rows = packed[idx].reshape(h.shape + (packed.shape[1],))
    # The table stores RAW hash bits, h is the signed view: un-flip it, both
    # sides then hold the same 32-bit pattern in the same dtype.
    found = (rows[..., 0] == (h ^ _I32_MIN)) & mask
    return found, rows


def _group_hits(cfg: _Cfg, g: int, found, rows, is_fw):
    """Bit extraction for the (up to) 32 loci of group g:
    (rare_b, fw_hit, bw_hit), each [B, S, n_here] bool.  `rare_b` is read
    ungated by `found`; every use of it is and-ed with a hit."""
    G = cfg.n_groups
    zero = torch.zeros((), dtype=torch.int32, device=rows.device)
    fmask = torch.where(found, rows[..., 1 + g], zero)
    bmask = torch.where(found, rows[..., 1 + G + g], zero)
    rmask = rows[..., 1 + 2 * G + g]
    # Read-direction semantics (BaseMatchCount::inc): the "forward" counter
    # counts entries whose direction includes the read minimizer's own
    # direction; "backward" the opposite.
    m_fwdir = torch.where(is_fw, fmask, bmask)
    m_bwdir = torch.where(is_fw, bmask, fmask)
    n_here = min(32, cfg.n_loci - 32 * g)
    bits = torch.arange(n_here, dtype=torch.int32, device=rows.device)
    # (x >> b) & 1 is the same under an arithmetic or a logical shift.
    rare_b = ((rmask[..., None] >> bits) & 1) != 0
    fw_hit = ((m_fwdir[..., None] >> bits) & 1) != 0
    bw_hit = ((m_bwdir[..., None] >> bits) & 1) != 0
    return rare_b, fw_hit, bw_hit


def _group_counts(rare_b, fw_hit, bw_hit):
    """[B, n_here, 4] = [bw_c, fw_c, bw_r, fw_r] summed over positions."""
    return torch.stack([(bw_hit & ~rare_b).sum(dim=1),
                        (fw_hit & ~rare_b).sum(dim=1),
                        (bw_hit & rare_b).sum(dim=1),
                        (fw_hit & rare_b).sum(dim=1)], dim=-1)


def _mate_counters(reads, cfg: _Cfg, keys_signed, packed):
    """Per-locus counters [B, n_loci, 4] = [bw_c, fw_c, bw_r, fw_r] (int64)
    and the minimizer totals [B] — via bitmap extraction, no scatters.  The
    groups of 32 loci go one after another, so that only one group's
    [B, S, 32] temporaries are alive at a time."""
    P = reads.shape[1] - cfg.k + 1
    h, is_fw, mask, total = minimizer_front(reads, cfg.k, cfg.w,
                                            _front_S(P, cfg.w))
    found, rows = _lookup_rows(cfg, h, mask, keys_signed, packed)
    per_group = [_group_counts(*_group_hits(cfg, g, found, rows, is_fw))
                 for g in range(cfg.n_groups)]
    return torch.cat(per_group, dim=1), total.to(torch.int64)


def _pack_decisions(dec):
    """[B, n_loci] bool -> [B, G] int32 bit patterns of the locus bitmaps:
    decisions leave the device packed, 32 loci a word."""
    B, n = dec.shape
    G = max(-(-n // 32), 1)
    if 32 * G - n:
        dec = torch.nn.functional.pad(dec, (0, 32 * G - n))
    d = dec.reshape(B, G, 32).to(torch.int64)
    bits = torch.arange(32, dtype=torch.int64, device=dec.device)
    words = (d << bits).sum(dim=2)
    # Two's-complement wrap into the int32 bit pattern.
    return torch.where(words >= SIGN_BIT, words - (1 << 32),
                       words).to(torch.int32)


def unpack_decisions(arr, n_loci: int) -> np.ndarray:
    """Host inverse of _pack_decisions; passes bool arrays through."""
    arr = np.asarray(arr)
    if arr.dtype == np.bool_:
        return arr
    bits = np.unpackbits(np.ascontiguousarray(arr).view(np.uint8), axis=1,
                         bitorder="little")
    return bits[:, :n_loci].view(np.bool_)


def _numer_denoms(counts, total):
    """fw/bw weighted numerators and denominators (recruit.rs:294-348)."""
    bw_c, fw_c, bw_r, fw_r = counts.unbind(dim=-1)
    t = total[:, None]
    fw_n = RARE_WORTH * fw_r + fw_c
    bw_n = RARE_WORTH * bw_r + bw_c
    fw_d = RARE_WORTH * (t - fw_c) + fw_c
    bw_d = RARE_WORTH * (t - bw_c) + bw_c
    has_rare = (bw_r > 0) | (fw_r > 0)
    return fw_n, bw_n, fw_d, bw_d, has_rare


def _short_decide(cfg: _Cfg, reads, keys_signed, packed):
    """Packed [B, G] decisions for short single-end reads."""
    counts, total = _mate_counters(reads, cfg, keys_signed, packed)
    fw_n, bw_n, fw_d, bw_d, has_rare = _numer_denoms(counts, total)
    use_fw = fw_n >= bw_n
    numer = torch.where(use_fw, fw_n, bw_n)
    denom = torch.where(use_fw, fw_d, bw_d).clamp(min=1)
    passed = numer * cfg.frac_q >= cfg.frac_p * denom
    return _pack_decisions(has_rare & passed)


def _pairs_decide(cfg: _Cfg, both, keys_signed, packed):
    """Packed [B, G] decisions for read pairs (strand-consistent joint
    orientation, both mates must pass; recruit.rs:885-932).  both = [2B, L]
    codes, mate-1 rows then mate-2 rows: ONE counter pass for both mates."""
    B = both.shape[0] // 2
    c, t = _mate_counters(both, cfg, keys_signed, packed)
    fw_n1, bw_n1, fw_d1, bw_d1, rare1 = _numer_denoms(c[:B], t[:B])
    fw_n2, bw_n2, fw_d2, bw_d2, rare2 = _numer_denoms(c[B:], t[B:])
    use_fw1 = fw_n1 + bw_n2 >= bw_n1 + fw_n2
    n1 = torch.where(use_fw1, fw_n1, bw_n1)
    d1 = torch.where(use_fw1, fw_d1, bw_d1).clamp(min=1)
    n2 = torch.where(use_fw1, bw_n2, fw_n2)
    d2 = torch.where(use_fw1, bw_d2, fw_d2).clamp(min=1)
    ok1 = n1 * cfg.frac_q >= cfg.frac_p * d1
    ok2 = n2 * cfg.frac_q >= cfg.frac_p * d2
    # Mate-1 must have at least one match at the locus (the reference never
    # inserts mate-2-only loci, recruit.rs:915-917).
    any1 = c[:B].sum(dim=-1) > 0
    return _pack_decisions((rare1 | rare2) & ok1 & ok2 & any1)


def _max_subarray(v):
    """Max subarray sum (at least 0) along dim 1 of integer v [B, S, n]: the
    reference's sequential Kadane loop (recruit.rs:940-964) as
    max_j (c_j - min_{i<j} c_i) over the prefix sums c, c_{-1} = 0.
    Integer sums are exact in any order."""
    c = torch.cumsum(v, dim=1)                          # int64
    low = torch.cummin(c, dim=1).values
    low = torch.cat([torch.zeros_like(low[:, :1]), low[:, :-1]],
                    dim=1).clamp_(max=0)
    return (c - low).amax(dim=1).clamp_(min=0)


def _long_decide(cfg: _Cfg, reads, keys_signed, packed, stretch_minims: int,
                 stretch_score: int):
    """Packed [B, G] decisions for long single-end reads
    (recruit.rs:966-997): rare-match fraction threshold + Kadane matching
    stretch, both evaluated for every locus at once on the device."""
    h, is_fw, mask = minimizer_front(reads, cfg.k, cfg.w)
    total = mask.sum(dim=1)

    P = h.shape[1]
    S = _front_S(P, cfg.w)
    order = torch.argsort((~mask).to(torch.uint8), dim=1, stable=True)[:, :S]
    h, is_fw, mask = (torch.gather(t, 1, order) for t in (h, is_fw, mask))
    found, rows = _lookup_rows(cfg, h, mask, keys_signed, packed)

    # Counters (as _mate_counters) and per-position per-locus stretch
    # values: +PENALTY (+BONUS if rare) on a direction hit, then -PENALTY
    # per minimizer step; padding columns contribute 0.
    step = mask[..., None].to(torch.int32) * SUBSUM_PENALTY
    counts, best_fw, best_bw = [], [], []
    for g in range(cfg.n_groups):
        rare_b, fw_hit, bw_hit = _group_hits(cfg, g, found, rows, is_fw)
        counts.append(_group_counts(rare_b, fw_hit, bw_hit))
        x = SUBSUM_PENALTY + SUBSUM_BONUS * rare_b.to(torch.int32)
        best_fw.append(_max_subarray(fw_hit.to(torch.int32) * x - step))
        best_bw.append(_max_subarray(bw_hit.to(torch.int32) * x - step))
    bw_c, fw_c, bw_r, fw_r = torch.cat(counts, dim=1).unbind(dim=-1)
    best_fw = torch.cat(best_fw, dim=1)
    best_bw = torch.cat(best_bw, dim=1)

    use_fw = fw_r >= bw_r
    numer = torch.where(use_fw, fw_r, bw_r)
    denom = total[:, None] - torch.where(use_fw, fw_c, bw_c)
    # threshold = max(1, ceil(min(stretch_minims, denom) * p/q)), exact
    # integer rational (mirrors RecruitParams.long_read_threshold).
    m = denom.clamp(max=stretch_minims)
    thresh = (-torch.div(-m * cfg.frac_p, cfg.frac_q,
                         rounding_mode="floor")).clamp(min=1)
    frac_ok = numer >= thresh
    stretch_ok = ((denom < stretch_minims) | (best_fw >= stretch_score)
                  | (best_bw >= stretch_score))
    return _pack_decisions(frac_ok & stretch_ok)


class PendingDecisions:
    """Packed decisions of one dispatched batch: `device` is the [B, G]
    int32 tensor on the batch's device; on CUDA it is being copied into
    pinned host memory and `event` marks the copy's end."""

    def __init__(self, res):
        self.device = res
        self.event = None
        self._host = res
        if res.is_cuda:
            self._host = torch.empty(res.shape, dtype=res.dtype,
                                     pin_memory=True)
            self._host.copy_(res, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(res.device))

    def numpy(self) -> np.ndarray:
        """[B, G] uint32 locus bitmaps on the host (waits for the copy)."""
        if self.event is not None:
            self.event.synchronize()
        return self._host.numpy().view(np.uint32)


def _upload(dev, *mats):
    """[sum(B), L] int8 codes on `dev`: the matrices go up from pinned
    memory in one asynchronous copy."""
    both = np.concatenate(mats, axis=0) if len(mats) > 1 else mats[0]
    t = torch.from_numpy(np.ascontiguousarray(both, np.int8))
    if dev.type == "cuda":
        t = t.pin_memory().to(dev, non_blocking=True)
    return t


def run_long_async(index: DeviceIndex, reads: np.ndarray, stretch_minims: int,
                   stretch_score: int, device=None) -> PendingDecisions:
    """Dispatches one batch of long single reads; no host sync.
    device: None = CUDA (raises without one); "cpu" = plain PyTorch."""
    dev = _kernels.resolve_device(device)
    return PendingDecisions(_long_decide(
        index.cfg, _upload(dev, reads), *index.device_args(dev),
        stretch_minims, stretch_score))


def run_short_async(index: DeviceIndex, reads: np.ndarray,
                    device=None) -> PendingDecisions:
    dev = _kernels.resolve_device(device)
    return PendingDecisions(_short_decide(
        index.cfg, _upload(dev, reads), *index.device_args(dev)))


def run_pairs_async(index: DeviceIndex, reads1: np.ndarray,
                    reads2: np.ndarray, device=None) -> PendingDecisions:
    dev = _kernels.resolve_device(device)
    return PendingDecisions(_pairs_decide(
        index.cfg, _upload(dev, reads1, reads2), *index.device_args(dev)))


def run_long(index: DeviceIndex, reads: np.ndarray, stretch_minims: int,
             stretch_score: int, device=None) -> np.ndarray:
    """[B, n_loci] bool decisions for long single-end reads."""
    return unpack_decisions(
        run_long_async(index, reads, stretch_minims, stretch_score,
                       device).numpy(), index.n_loci)


def run_short(index: DeviceIndex, reads: np.ndarray, device=None):
    return unpack_decisions(run_short_async(index, reads, device).numpy(),
                            index.n_loci)


def run_pairs(index: DeviceIndex, reads1: np.ndarray, reads2: np.ndarray,
              device=None):
    return unpack_decisions(
        run_pairs_async(index, reads1, reads2, device).numpy(), index.n_loci)
