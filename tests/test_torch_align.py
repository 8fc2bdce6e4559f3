"""PyTorch port of the banded aligner vs the JAX package, on the CPU.

The same numpy inputs go through `locityper_tpu_torch.ops.align` (plain
PyTorch version, `device="cpu"`) and through the JAX package's two kernels:
the Pallas kernel in TPU interpret mode — which the port follows op for op —
and the XLA scan kernel `ops.align.align_batch`, whose deletion scan is
unbounded and takes ties with `>=`, so a small share of jobs may differ.
"""
import jax  # noqa: F401  (conftest pins it to the CPU)
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from locityper_tpu.ops import align as JA
from locityper_tpu.ops.align_pallas import (align_batch_pallas,
                                            align_batch_pallas_stream)
from locityper_tpu.sim import ErrorModel, random_genome
from locityper_tpu_torch.ops import align as TA

# One intra-op thread: the suite runs several workers side by side, and the
# tensors here are small.
torch.set_num_threads(1)

SC = JA.Scores.from_error_rates(0.002, 0.0002, 0.0002)
SCORE_VEC = np.array(SC.astuple(), dtype=np.float32)
INT_KEYS = ("n_mism", "n_ins", "n_del", "n_clip", "start_p", "end_p", "valid")


def make_batch(rng, B, L, band, err=None, hard=False):
    """Reads drawn from a random haplotype with sequencing errors.  With
    `hard`, also: reads much shorter than L, N bases in reads and windows,
    and deletions of 8-44 bases (some longer than the 32-run cap)."""
    err = err or ErrorModel(0.01, 0.003, 0.003)
    hap = random_genome(rng, 50_000)
    reads = np.full((B, L), 4, np.int8)
    lens = np.zeros(B, np.int32)
    wins = np.full((B, L + band), 4, np.int8)
    for i in range(B):
        start = int(rng.integers(band, hap.size - 2 * L - 1))
        span = L if not hard or i % 4 else int(rng.integers(L // 3, L))
        src = hap[start:start + span + 64]
        if hard and i % 3 == 0:
            cut = int(rng.integers(20, span - 20))
            gap = int(rng.integers(8, 45))
            src = np.concatenate([src[:cut], src[cut + gap:]])
        r = err.apply(rng, src[:span])[:span].copy()
        if hard and i % 5 == 0:
            r[rng.integers(0, r.size, 3)] = 4
        lens[i] = r.size
        reads[i, :r.size] = r
        w = JA.extract_windows(hap, np.array([start - band // 2]),
                               L + band)[0].copy()
        if hard and i % 7 == 0:
            w[rng.integers(0, w.size, 2)] = 4
        wins[i] = w
    return reads, lens, wins


def run_torch(reads, lens, wins, band):
    res = TA.align_batch(reads, lens, wins, SCORE_VEC, band=band,
                         device="cpu")
    return {k: v.numpy() for k, v in res.items()}


def run_pallas(reads, lens, wins, band):
    with pltpu.force_tpu_interpret_mode():
        res = align_batch_pallas(reads, lens, wins, SCORE_VEC, band=band,
                                 tile=128)
    return {k: np.asarray(v) for k, v in res.items()}


@pytest.mark.parametrize("B,L,band,hard", [(256, 128, 32, False),
                                           (128, 192, 48, True)])
def test_reference_matches_pallas_kernel(B, L, band, hard):
    """Tolerances: score 2e-3 (f32 sums of ln-probs of magnitude ~1e2-1e3;
    the Pallas interpreter may fuse a multiply-add), integers equal on at
    least 99 % of jobs.  Observed here: 0 jobs differ in both cases."""
    rng = np.random.default_rng(0 if not hard else 7)
    reads, lens, wins = make_batch(rng, B, L, band, hard=hard)
    got = run_torch(reads, lens, wins, band)
    want = run_pallas(reads, lens, wins, band)
    np.testing.assert_allclose(got["score"], want["score"], atol=2e-3)
    same = np.ones(B, bool)
    for k in INT_KEYS:
        same &= got[k] == want[k]
    assert same.mean() >= 0.99, f"{(~same).sum()} of {B} jobs differ"
    if hard:
        assert (want["n_del"] >= 8).any(), "no long deletion was exercised"
        assert (lens < L - 16).any()


@pytest.mark.parametrize("L", [2048, 8704])
def test_reference_matches_row_streamed_pallas_kernel(L):
    """Long rows.  The JAX package switches to a second kernel there, which
    streams the read rows in blocks of 512 with the DP state carried in
    scratch memory (`align_batch_pallas_stream`, picked for L > 8192); the
    port keeps one kernel with no row cap.  The interpreter does take the
    stream kernel's scratch state, so the plain version is held against it
    directly: 128 jobs (one tile, the fewest it takes) at band 160, at the
    shape of the package's own TPU-gated test and at 17 blocks, above 8,192
    rows.  Tolerances as above; observed here: 0 jobs differ, scores equal
    to the bit."""
    rng = np.random.default_rng(5)
    B, band = 128, 160
    reads, lens, wins = make_batch(rng, B, L, band, hard=True)
    got = run_torch(reads, lens, wins, band)
    with pltpu.force_tpu_interpret_mode():
        want = {k: np.asarray(v) for k, v in align_batch_pallas_stream(
            reads, lens, wins, SCORE_VEC, band=band, block_rows=512).items()}
    np.testing.assert_allclose(got["score"], want["score"], atol=2e-3)
    same = np.ones(B, bool)
    for k in INT_KEYS:
        same &= got[k] == want[k]
    assert same.mean() >= 0.99, f"{(~same).sum()} of {B} jobs differ"
    assert got["valid"].all() and lens.max() == L
    assert (want["n_del"] >= 8).any(), "no long deletion was exercised"


def test_reference_vs_xla_scan_kernel():
    """Against the JAX package's XLA kernel the repo's own bounds apply
    (tests/test_align_pallas.py): score atol 2e-3, < 2 % of jobs differ per
    integer output — its deletion scan is unbounded and takes ties with
    `>=`, the Pallas kernel (and the port) cap runs and take `>`."""
    rng = np.random.default_rng(0)
    B, L, band = 256, 128, 32
    reads, lens, wins = make_batch(rng, B, L, band)
    got = run_torch(reads, lens, wins, band)
    want = {k: np.asarray(v) for k, v in
            JA.align_batch(reads, lens, wins, SCORE_VEC, band=band).items()}
    np.testing.assert_allclose(got["score"], want["score"], atol=2e-3)
    for k in INT_KEYS:
        assert np.mean(got[k] != want[k]) < 0.02, k


def test_any_batch_size_and_length():
    """No multiple-of-128 batch, no row cap: 37 jobs of L=70 equal the same
    jobs padded to 128 × 128 (pad rows are never read past `lens`)."""
    rng = np.random.default_rng(3)
    reads, lens, wins = make_batch(rng, 37, 70, 20)
    a = run_torch(reads, lens, wins, 20)
    reads_p = np.full((128, 128), 4, np.int8)
    wins_p = np.full((128, 148), 4, np.int8)
    lens_p = np.zeros(128, np.int32)
    reads_p[:37, :70], wins_p[:37, :90], lens_p[:37] = reads, wins, lens
    b = run_torch(reads_p, lens_p, wins_p, 20)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k][:37], err_msg=k)
    assert not b["valid"][37:].any()


def test_payloads_are_32_bit():
    """Separate int32 payloads: a read declared 70,000 bases long whose
    tail past the 16 supplied matching bases is clipped reports
    n_clip > 65,535 (the Pallas kernel's 16-bit fields wrap there).  Only
    the first L = 64 rows are supplied, so the walk stays short."""
    L, band = 64, 8
    reads = np.full((1, L), 4, np.int8)          # N after 16 matching bases
    reads[0, :16] = 0
    lens = np.array([70_000], np.int32)
    wins = np.zeros((1, L + band), np.int8)
    res = run_torch(reads, lens, wins, band)
    assert int(res["n_clip"][0]) == 70_000 - 16
    assert int(res["end_p"][0]) == 16
    assert int(res["n_mism"][0]) == 0 and bool(res["valid"][0])
    wrapped = run_pallas(np.tile(reads, (128, 1)), np.tile(lens, 128),
                         np.tile(wins, (128, 1)), band)
    assert int(wrapped["n_clip"][0]) == (70_000 - 16) % 65_536


def test_extract_windows_and_edit_equal():
    rng = np.random.default_rng(11)
    hap = random_genome(rng, 500)
    starts = np.array([-30, -1, 0, 17, 460, 499, 520], np.int64)
    np.testing.assert_array_equal(TA.extract_windows(hap, starts, 64),
                                  JA.extract_windows(hap, starts, 64))
    assert TA.extract_windows(hap, np.empty(0, np.int64), 64).shape == (0, 64)
    res = {k: rng.integers(0, 9, 20) for k in
           ("n_mism", "n_ins", "n_del", "n_clip")}
    rl = np.full(20, 150)
    for a, b in zip(TA.edit_and_matches(res, rl), JA.edit_and_matches(res, rl)):
        np.testing.assert_array_equal(a, b)
    assert TA.ALIGN_RESULT_KEYS == JA.ALIGN_RESULT_KEYS
    assert TA.Scores.from_error_rates(0.01, 0.002, 0.003).astuple() == \
        JA.Scores.from_error_rates(0.01, 0.002, 0.003).astuple()


def test_cuda_tensor_never_takes_the_plain_version():
    """The wrapper picks the plain version only for CPU tensors; with no
    CUDA device `device=None` raises and never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    reads, lens, wins = make_batch(np.random.default_rng(1), 4, 64, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TA.align_batch(reads, lens, wins, SCORE_VEC, band=16)


# ---------------------------------------------------------------------------
# The CUDA kernel's best-end rule, checked on the CPU.  The plain version
# looks for the best end row by row; the kernel lets every lane keep the
# best of its own cells (cell j lives in lane j % lanes) and reduces once.
# ---------------------------------------------------------------------------

def row_by_row_best(cand):
    """The plain version's rule on cand [rows, band]: the first row to reach
    the maximum (strict '>'), the smallest j among that row's maxima."""
    best, where = np.float32(TA.NEG), (0, 0)
    for i, row in enumerate(cand, start=1):
        if row.max() > best:
            best, where = row.max(), (i, int(np.argmax(row)))
    return best, where


def per_lane_best(cand, lanes):
    """The kernel's rule: per lane the best of its own cells over all rows,
    strict '>' in the order (row, register); then over the lanes the largest
    score, the smallest row, the smallest j."""
    tops = []
    for lane in range(lanes):
        best, where = np.float32(TA.NEG), (0, lane)
        for i, row in enumerate(cand, start=1):
            for j in range(lane, cand.shape[1], lanes):
                if row[j] > best:
                    best, where = row[j], (i, j)
        tops.append((-best, where))
    neg_best, where = min(tops)
    return -neg_best, where


def candidate_rows(reads, lens, wins, band, max_del_run=32):
    """Row scores plus end bonus, [rows, N, band], and the share of rows in
    which some cell takes a deletion origin: the plain version's walk without
    its payloads."""
    sv = torch.from_numpy(SCORE_VEC)
    m_sc, x_sc, i_sc, d_sc, c_sc = (sv[k] for k in range(5))
    reads, wins = torch.from_numpy(reads), torch.from_numpy(wins)
    lens_f = torch.from_numpy(lens).to(torch.float32)[:, None]
    N, L = reads.shape
    j_idx = torch.arange(band, dtype=torch.int32)[None, :]
    jd = j_idx.to(torch.float32) * d_sc
    prev = torch.zeros((N, band))
    neg_col = torch.full((N, 1), TA.NEG)
    out, n_del_rows = [], 0
    for i in range(1, L + 1):
        r_c, h_c = reads[:, i - 1:i], wins[:, i - 1:i - 1 + band]
        sub = torch.where(r_c == h_c, m_sc, x_sc)
        sub = torch.where((h_c < 4) & (r_c < 4), sub, TA.NEG)
        ins_s = torch.cat([prev[:, 1:], neg_col], dim=1) + i_sc
        ins_s[:, band - 1] = TA.NEG
        base_s = torch.maximum(torch.maximum(ins_s, prev + sub),
                               c_sc * float(i))
        adj, orig, s = base_s - jd, j_idx.expand(N, band), 1
        while s < min(max_del_run, band):
            sh_adj = torch.cat([neg_col.expand(N, s), adj[:, :-s]], dim=1)
            take = sh_adj > adj
            adj = torch.where(take, sh_adj, adj)
            orig = torch.where(take, torch.roll(orig, s, dims=1), orig)
            s *= 2
        prev = torch.where(orig == j_idx, base_s, adj + jd)
        n_del_rows += int((orig != j_idx).any(dim=1).sum())
        out.append(prev + (lens_f - float(i)) * c_sc)
    return torch.stack(out).numpy(), n_del_rows / (N * L)


@pytest.mark.parametrize("band,lanes", [(20, 32), (48, 16), (160, 32)])
@pytest.mark.parametrize("source", ["quantised", "aligner"])
def test_per_lane_best_end_equals_row_by_row_rule(source, band, lanes):
    """Same (score, row, j) from both rules, on random scores quantised to
    five values (ties everywhere) and on the candidate rows of real jobs,
    whose end_p must also be the plain version's."""
    rng = np.random.default_rng(band)
    if source == "quantised":
        cands = rng.integers(-5, 0, (12, 40, band)).astype(np.float32)
        cands = cands.transpose(1, 0, 2)                  # [rows, jobs, band]
    else:
        reads, lens, wins = make_batch(rng, 12, 96, band, hard=True)
        lens[:] = 96           # candidate_rows walks all rows of every job
        reads[reads == 4] = 0
        cands, _ = candidate_rows(reads, lens, wins, band)
        want = run_torch(reads, lens, wins, band)
    for n in range(cands.shape[1]):
        score, (row, j) = row_by_row_best(cands[:, n])
        assert per_lane_best(cands[:, n], lanes) == (score, (row, j)), n
        if source == "aligner":
            assert score == want["score"][n] and row + j == want["end_p"][n]


def test_a_deletion_origin_is_taken_in_most_rows():
    """Why the kernel has no fast path for rows without deletion origins:
    right of a read's diagonal a deletion from the diagonal beats a
    mismatch, so nearly every row has a cell whose origin is another cell."""
    rng = np.random.default_rng(2)
    reads, lens, wins = make_batch(rng, 32, 150, 48)
    _, share = candidate_rows(reads, lens, wins, 48)
    assert share > 0.9, share
