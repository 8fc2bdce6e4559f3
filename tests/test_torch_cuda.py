"""The CUDA kernels against their plain PyTorch versions, on a card.

These tests need an NVIDIA GPU and `nvcc`; they skip on a machine without
one.  Run them there with `python -m pytest tests/test_torch_cuda.py -q`;
`python3 chip_smoke.py` makes the same comparisons at full size.
"""
import numpy as np
import pytest
import torch

from locityper_tpu_torch.ops import align as TA
from locityper_tpu_torch.ops import solver_chains as TC

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("band", [20, 40, 48, 96, 128, 160, 192, 224, 256])
def test_align_kernel_equals_plain_version(card, band):
    """One band for each compiled variant (1..8 band cells a lane, and 3
    cells in each of 16 lanes for bands 33..48)."""
    rng = np.random.default_rng(band)
    N, L = 999, 192
    hap = rng.integers(0, 4, 20_000).astype(np.int8)
    start = rng.integers(band, hap.size - 2 * L, N)
    reads = hap[start[:, None] + np.arange(L)[None, :]].copy()
    reads[rng.random((N, L)) < 0.02] = 3
    lens = rng.integers(L // 2, L + 1, N).astype(np.int32)
    wins = hap[(start - band // 2)[:, None] + np.arange(L + band)[None, :]]
    sv = torch.tensor(TA.Scores.from_error_rates(0.002, 0.0002, 0.0002)
                      .astuple(), dtype=torch.float32, device=card)
    args = [torch.from_numpy(x).to(card) for x in (reads, lens, wins)]
    got = TA.align_banded(*args, sv, band)
    want = TA.align_batch_reference(*args, sv, band)
    for k in TA.ALIGN_RESULT_KEYS:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("band", [48, 160])
@pytest.mark.parametrize("case", ["empty_reads", "late_deletion",
                                  "odd_number_of_jobs"])
def test_align_kernel_edge_cases(card, case, band):
    """Reads of length 0 give no result (score NEG, zeros); a deletion a few
    bases before the read's end is carried into the best end of the last
    row; an odd number of jobs leaves the last half warp of band 48 without
    a job.  All outputs bit-identical to the plain version."""
    rng = np.random.default_rng(band)
    N, L = (777 if case == "odd_number_of_jobs" else 512), 96
    hap = rng.integers(0, 4, 20_000).astype(np.int8)
    start = rng.integers(band, hap.size - 2 * L - 8, N)
    col = np.arange(L)[None, :]
    if case == "late_deletion":
        col = col + (col >= L - 5) * 2
    reads = hap[start[:, None] + col].copy()
    lens = np.full(N, L, np.int32)
    if case == "empty_reads":
        reads[::3], lens[::3] = 4, 0
    wins = hap[(start - band // 2)[:, None] + np.arange(L + band)[None, :]]
    sv = torch.tensor(TA.Scores.from_error_rates(0.002, 0.0002, 0.0002)
                      .astuple(), dtype=torch.float32, device=card)
    args = [torch.from_numpy(x).to(card) for x in (reads, lens, wins)]
    got = TA.align_banded(*args, sv, band)
    want = TA.align_batch_reference(*args, sv, band)
    for k in TA.ALIGN_RESULT_KEYS:
        assert torch.equal(got[k], want[k]), k
    if case == "empty_reads":
        assert not bool(got["valid"][::3].any())
        assert bool((got["score"][::3] == TA.NEG).all())
        assert not bool(got["end_p"][::3].any())
        assert bool(got["valid"][1::3].all())
    if case == "late_deletion":
        assert int((got["n_del"] == 2).sum()) > N // 2
        assert int((got["end_p"] == band // 2 + L + 2).sum()) > N // 2


def chain_tensors(card, G, A, R, K, W, D, seed=0):
    """Random inputs of `anneal_chains` on the card."""
    g = torch.Generator(device=card).manual_seed(seed)
    C = G * A
    probs = -4 * torch.rand((G, R, K), generator=g, device=card)
    w = torch.randint(0, W, (C, R, K, 2), generator=g, device=card,
                      dtype=torch.int32)
    winpk = w[..., 0] | (w[..., 1] << 16)
    vcount = torch.randint(1, K + 1, (G, R), generator=g, device=card,
                           dtype=torch.int32)
    nontrivial = vcount > 1
    nt_ixs = torch.argsort((~nontrivial).to(torch.uint8), dim=1,
                           stable=True).to(torch.int32)
    ntc = nontrivial.sum(1).clamp_min(1).to(torch.int32)
    start_temp = torch.full((G,), 5.0, device=card)
    wtab = -torch.rand((C, W, D), generator=g, device=card)
    assgn0 = torch.zeros((C, R), dtype=torch.int32, device=card)
    depth0 = torch.zeros((C, W), dtype=torch.int32, device=card)
    ones = torch.ones((C, R), dtype=torch.int32, device=card)
    depth0.scatter_add_(1, (winpk[:, :, 0] & 0xFFFF).long(), ones)
    depth0.scatter_add_(1, (winpk[:, :, 0] >> 16).long(), ones)
    cache0 = torch.gather(wtab, 2, depth0.clamp(0, D - 1).long()[..., None])[..., 0]
    return (probs, winpk, vcount, nt_ixs, ntc, start_temp, wtab, assgn0,
            depth0, cache0)


def test_anneal_kernel_equals_plain_version(card):
    args = chain_tensors(card, 5, 4, 30, 5, 20, 64)
    kw = dict(attempts=4, n_steps=1500, anneal_steps=0, dc=1.85, ac=0.15,
              plato=200, seed=7)
    for a, b in zip(TC.anneal_chains(*args, **kw),
                    TC.anneal_chains_reference(*args, **kw)):
        assert torch.equal(a, b)


#: (G, A, R, K, W, D), n_steps, anneal_steps, plato
ANNEAL_CASES = {
    "steps_no_multiple_of_32": ((5, 4, 30, 5, 20, 64), 1501, 700, 0),
    "fewer_steps_than_a_batch": ((5, 4, 30, 5, 20, 64), 31, 20, 0),
    "plateau_below_32": ((5, 4, 30, 5, 20, 64), 1500, 300, 5),
    "plateau_ends_inside_a_batch": ((5, 4, 30, 5, 20, 64), 1500, 0, 77),
    "cooling_ends_inside_a_batch": ((5, 4, 30, 5, 20, 64), 1000, 401, 150),
    "chains_no_multiple_of_a_block": ((3, 3, 30, 5, 20, 64), 800, 300, 100),
    "few_windows_many_conflicts": ((4, 4, 64, 6, 6, 32), 2000, 1500, 0),
    # A chain's state takes 4 (R + 3 W) bytes of shared memory: two chains
    # fill a block, beyond the 48 KB a kernel gets unasked; then one chain
    # fits no block and the same kernel keeps the state in global memory.
    "two_chains_fill_shared_memory": ((2, 3, 20_000, 2, 20, 8), 600, 300, 3),
    "state_in_global_memory": ((2, 3, 60_000, 2, 20, 8), 600, 300, 3),
}


@pytest.mark.parametrize("case", sorted(ANNEAL_CASES))
def test_anneal_kernel_schedule_cases(card, case):
    """The batched walk of the kernel (32 steps a warp at a time) equals
    the step-by-step plain version exactly: assignments, likelihoods and
    step counts."""
    shape, n_steps, anneal_steps, plato = ANNEAL_CASES[case]
    args = chain_tensors(card, *shape, seed=len(case))
    kw = dict(attempts=shape[1], n_steps=n_steps, anneal_steps=anneal_steps,
              dc=1.85, ac=0.15, plato=plato, seed=11)
    schedule = torch.zeros(2, dtype=torch.int64, device=card)
    got = TC.anneal_chains(*args, schedule=schedule, **kw)
    rounds, batches = schedule.tolist()
    want = TC.anneal_chains_reference(*args, **kw)
    for name, a, b in zip(("lik", "assgn", "steps_done"), got, want):
        assert torch.equal(a, b), name
    if plato:
        assert int(got[2].min()) < n_steps, "no chain froze"
    else:
        assert batches == shape[0] * shape[1] * -(-n_steps // 32)
    assert batches <= rounds <= 32 * batches


@pytest.mark.parametrize("B,L,k,w", [
    (1, 15, 15, 10), (257, 152, 15, 10), (4096, 192, 15, 10),
    (64, 16384, 15, 10),
    # The edges of the kernel's schedule: a warp a row or a chunk of 256
    # positions, 4 warps a block, a slice of shared memory a warp.
    (5, 200, 15, 10),           # rows no multiple of the warps a block
    (333, 1000, 15, 10),        # S = P // 16 cuts inside a later chunk
    (129, 1001, 13, 12),        # rows of no multiple of 16 bytes
    (257, 152, 16, 10),         # k = 16: k-mers fill the 32-bit word
    (9, 2000, 15, 1024),        # 4 warps of 35,072 B: past 48 KB a block
    (0, 192, 15, 10),           # an empty batch
])
def test_minimizer_front_kernel_equals_plain_version(card, B, L, k, w):
    """Both entries of minimizer_front.cu, bit-identical on every output:
    reads with N and negative int8 codes, a row of one repeated base (every
    hash ties), a run of N, a truncating S, rows that span many chunks."""
    from locityper_tpu_torch.ops import recruit as TR
    rng = np.random.default_rng(B + L)
    reads = rng.integers(0, 4, (B, L)).astype(np.int8)
    reads[rng.random((B, L)) < 0.01] = 4
    reads[rng.random((B, L)) < 0.002] = -1
    if B:
        reads[B // 2] = 3
        reads[B // 3, L // 4:L // 2] = 4
    reads = torch.from_numpy(reads).to(card)
    got = TR.minimizer_front(reads, k, w)
    want = TR.minimizer_front_reference(reads, k, w)
    for name, a, b in zip(("hs", "is_fw", "mask"), got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    P = L - k + 1
    assert bool(want[2].any()) or not B or P < w
    if L == 1000:
        cut = (want[2].cumsum(1) >= P // 16).to(torch.uint8).argmax(1)
        assert bool(((want[2].sum(1) > P // 16) & (cut >= 256)).any())
    for S in (TR._front_S(P, w), max(P // 16, 1), P + 5):
        got = TR.minimizer_front(reads, k, w, S)
        want = TR.minimizer_front_reference(reads, k, w, S)
        for name, a, b in zip(("hs", "is_fw", "mask", "total"), got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), (name, S)
    for k2, w2 in ((11, 5), (7, 1), (15, 40), (16, 10)):
        if L < k2:
            continue
        for S in (None, 12):
            got = TR.minimizer_front(reads, k2, w2, S)
            want = TR.minimizer_front_reference(reads, k2, w2, S)
            for a, b in zip(got, want):
                assert torch.equal(a, b), (k2, w2, S)


def ilp_problem(seed, n_reads=40, n_haps=3, kh=3):
    """tests/test_ilp.py:small_problem, built with the port's own classes
    (the card's machine has no JAX): small enough for the exact ILP
    oracle, tweak = 0."""
    from locityper_tpu_torch.mathx.distr import NBinom
    from locityper_tpu_torch.model import Params
    from locityper_tpu_torch.model.assgn import LocusTensors
    from locityper_tpu_torch.model.windows import ContigInfoPack
    from locityper_tpu_torch.ops.solver import build_bayes_table
    rng = np.random.default_rng(seed)
    hap_len, window, n_win = 1500, 100, 8
    hap_prob = rng.normal(-4.0, 2.0, (n_haps, n_reads, kh)).astype(np.float32)
    hap_prob[rng.random((n_haps, n_reads, kh)) < 0.35] = -1e30
    mid = rng.integers(0, hap_len, (n_haps, n_reads, kh, 2)).astype(np.int32)
    mid[rng.random((n_haps, n_reads, kh, 2)) < 0.15] = -1
    tensors = LocusTensors(hap_prob, mid, np.full(n_reads, -30.0, np.float32),
                           n_haps, n_reads, kh)
    pack = ContigInfoPack(
        n_haps=n_haps, max_len=hap_len, max_windows=32,
        n_windows=np.full(n_haps, n_win, np.int32),
        reg_start=np.full(n_haps, (hap_len - n_win * window) // 2, np.int32),
        contig_len=np.full(n_haps, hap_len, np.int32), window_size=window,
        gc_at=rng.integers(35, 60, (n_haps, hap_len)).astype(np.int32),
        weight_at=rng.uniform(0.6, 1.0, (n_haps, hap_len)).astype(np.float32))
    bayes = build_bayes_table([NBinom(4.0, 0.45)] * 101, [0.3, 2.0, 3.0], 2.0)
    return tensors, pack, bayes, Params(tweak=0)


def run_seq(device, seed, gts, problem, attempts, random_init, **cfg):
    from locityper_tpu_torch.ops import solver as TS
    tensors, pack, bayes, params = problem
    config = TS.SolverConfig(
        depth_contrib=params.depth_contrib, aln_contrib=params.aln_contrib,
        prob_diff=params.prob_diff, tweak=0, window_size=pack.window_size,
        **cfg)
    liks, assgn = TS.solve_genotypes(
        seed, np.asarray(gts), tensors.hap_prob, tensors.hap_mid,
        tensors.unmapped_prob, pack.n_windows, pack.reg_start,
        pack.contig_len, pack.gc_at, pack.weight_at, bayes, config,
        n_attempts=attempts, max_windows=pack.max_windows,
        random_init=random_init, device=device)
    return liks.cpu().numpy(), assgn.cpu().numpy()


ALL_GTS = [(a, b) for a in range(3) for b in range(a, 3)]


@pytest.mark.parametrize("random_init", [False, True])
def test_seq_greedy_chain_equal_on_card_and_cpu(card, random_init):
    """The sequential engine's greedy: its decisions are float32 adds and
    multiplies of gathered values and its draws are counted, so the card
    and the CPU walk the same way: equal assignments, likelihoods within
    1e-4."""
    problem = ilp_problem(1)
    kw = dict(greedy_sample=10, plato_size=100)
    a = run_seq(card, 3, ALL_GTS, problem, 8, random_init, **kw)
    b = run_seq("cpu", 3, ALL_GTS, problem, 8, random_init, **kw)
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_allclose(a[0], b[0], rtol=0, atol=1e-4)


def test_seq_chain_reaches_ilp_optimum_on_card(card):
    """The sequential engine's annealing chain on the card
    (tests/test_ilp.py:57, best of 64 attempts, as tests/test_torch_seq.py
    asks of it on the CPU)."""
    from locityper_tpu_torch.solvers import ilp
    for seed in (0, 1, 2):
        problem = ilp_problem(seed)
        tensors, pack, bayes, params = problem
        _, ilp_lik = ilp.solve_ilp((0, 2), tensors, pack, bayes, params)
        liks, _ = run_seq(card, seed, [(0, 2)], problem, 64, True,
                          anneal_steps=4000, polish_steps=4000)
        assert float(liks.max()) == pytest.approx(ilp_lik, abs=1e-3)
        assert float(liks.max()) <= ilp_lik + 1e-3


def card_mesh(card, n=2):
    from locityper_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(devices=[card] * n)


def card_job_table(N=999, L=150, band=48, seed=2):
    """N reads cut from one haplotype, half of the mates stored reverse
    complemented, a few windows over either end of the haplotype."""
    from types import SimpleNamespace

    from locityper_tpu_torch.model.locs import _prepare_align_jobs
    rng = np.random.default_rng(seed)
    hap = rng.integers(0, 4, 20_000).astype(np.int8)
    start = rng.integers(band, hap.size - 2 * L, N)
    start[:5] = (-L - band - 7, -band, 3, hap.size - L, hap.size + 9)
    reads = hap[np.clip(start[:, None] + np.arange(L)[None, :], 0,
                        hap.size - 1)].copy()
    reads[rng.random((N, L)) < 0.02] = 3
    lens = rng.integers(L // 2, L + 1, N)
    strand = rng.integers(0, 2, N)
    mates = [(3 - r[:n][::-1]).astype(np.int8) if s else r[:n]
             for r, n, s in zip(reads, lens, strand)]
    table, _ = _prepare_align_jobs(
        mates, (np.arange(N), np.zeros(N, np.int64), strand, start),
        SimpleNamespace(seqs=[hap]), band, L=L)
    sv = np.array(TA.Scores.from_error_rates(0.002, 0.0002, 0.0002)
                  .astuple(), np.float32)
    return table, sv, band


def test_job_table_gathered_on_the_card_equals_the_cpu(card):
    """A job table staged on the card gives the reads, lengths and windows
    that the same table gives on the CPU, byte for byte, also in a shard's
    padded slice."""
    table, sv, band = card_job_table()
    on_card = table.stage(sv, band, card)
    on_cpu = table.stage(sv, band, torch.device("cpu"))
    for lo, hi, n in ((0, len(table), None), (990, 999, 16)):
        for got, want in zip(on_card.gather(lo, hi, n),
                             on_cpu.gather(lo, hi, n)):
            assert got.is_cuda and got.dtype == want.dtype
            assert torch.equal(got.cpu(), want)


def test_sharded_align_on_a_grid_of_one_card(card):
    """K1 under a grid of two shards on the card: padding (999 jobs), one
    launch a shard, every output equal to the one-device call's."""
    from locityper_tpu_torch import _kernels
    from locityper_tpu_torch.model.locs import run_align_batches
    from locityper_tpu_torch.parallel.mesh import sharded_align
    table, sv, band = card_job_table()
    want = run_align_batches(table, sv, band, device=card)
    _kernels.reset_launches()
    got = sharded_align(card_mesh(card), table, sv, band)
    assert _kernels.LAUNCHES["align_banded"] == 2
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_sharded_recruit_on_a_grid_of_one_card(card):
    """K3 under a grid of two shards on the card: the packed decisions
    equal the one-device call's and the CPU's, mates row-aligned within a
    shard (63 pairs: padding)."""
    from locityper_tpu_torch import _kernels, sim
    from locityper_tpu_torch.ops import recruit as TR
    from locityper_tpu_torch.parallel.mesh import MeshPairRecruiter
    from locityper_tpu_torch.seq import dna
    from locityper_tpu_torch.seq.contigs import ContigSet
    from locityper_tpu_torch.seq.counts import (GenomeKmerCounter,
                                                off_target_counts)
    from locityper_tpu_torch.seq.recruit import RecruitParams, TargetIndex
    rng = np.random.default_rng(0)
    locus = sim.simulate_locus(rng, length=2000, n_haps=3)
    counter = GenomeKmerCounter(25)
    counter.add_seq(np.concatenate([sim.random_genome(rng, 5000),
                                    locus.haplotypes[0]]))
    counter.finalize()
    idx = TargetIndex(RecruitParams(match_frac=0.5))
    idx.add_locus(ContigSet(locus.name, locus.hap_names, locus.haplotypes),
                  off_target_counts(counter, locus.haplotypes,
                                    locus.haplotypes[0]))
    idx.finalize()
    dev = TR.DeviceIndex.from_index(idx)
    B, L = 63, 192
    r1 = np.full((B, L), 4, np.int8)
    r2 = np.full((B, L), 4, np.int8)
    for i in range(B):
        s = int(rng.integers(0, 1800))
        r1[i, :150] = locus.haplotypes[i % 3][s:s + 150]
        r2[i, :150] = dna.revcomp(locus.haplotypes[0][s:s + 150])
        if i % 5 == 0:
            r1[i, :150] = rng.integers(0, 4, 150)
    want = TR.run_pairs_async(dev, r1, r2, device=card).numpy()
    _kernels.reset_launches()
    got = MeshPairRecruiter(card_mesh(card), dev).run_async(r1, r2).numpy()
    assert _kernels.LAUNCHES["minimizer_front_compact"] == 2
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, TR.run_pairs_async(dev, r1, r2, device="cpu").numpy())
    hits = TR.unpack_decisions(got, dev.n_loci)
    assert hits.any() and not hits.all()


def test_sharded_stage_solver_on_a_grid_of_one_card(card):
    """K2 under a grid of two shards on the card: each shard's likelihoods
    and assignments equal one launch on its rows with its seed."""
    from locityper_tpu_torch import _kernels
    from locityper_tpu_torch.ops.solver import SolverConfig
    from locityper_tpu_torch.parallel.mesh import sharded_stage_solver
    from locityper_tpu_torch.utils.rng import derive_seed
    tensors, pack, bayes, params = ilp_problem(1)
    cfg = SolverConfig(anneal_steps=2000, polish_steps=1000, tweak=0,
                       window_size=pack.window_size)
    args = (tensors.hap_prob, tensors.hap_mid, tensors.unmapped_prob,
            pack.n_windows, pack.reg_start, pack.contig_len, pack.gc_at,
            pack.weight_at, bayes)

    def run(seed, gts, dev):
        return TC.solve_genotypes(seed, gts, *args, cfg, n_attempts=4,
                                  max_windows=pack.max_windows, device=dev)

    gts = np.array(ALL_GTS[:5])
    _kernels.reset_launches()
    liks, assgns = sharded_stage_solver(card_mesh(card), run, 21, gts)
    assert _kernels.LAUNCHES["anneal_chains"] == 2
    for ix, (lo, hi) in enumerate(((0, 3), (3, 5))):
        padded = np.concatenate([gts, gts[-1:]])[3 * ix:3 * ix + 3]
        one_l, one_a = run(derive_seed(21, "shard", ix), padded, card)
        assert torch.equal(liks[lo:hi], one_l[:hi - lo])
        assert torch.equal(assgns[lo:hi], one_a[:hi - lo])


@pytest.mark.parametrize("device", ["card", "cpu"])
def test_batched_engine_reaches_ilp_optimum(card, device):
    """`e=batched` (plain PyTorch) on the card and on the CPU:
    tests/test_ilp.py:78's bar, the best of 8 attempts of 1,000
    super-steps within 0.05 of the exact optimum."""
    from locityper_tpu_torch.ops import solver_batched as TB
    from locityper_tpu_torch.ops.solver import SolverConfig
    from locityper_tpu_torch.solvers import ilp
    dev = card if device == "card" else "cpu"
    for seed in (0, 1, 2):
        tensors, pack, bayes, params = ilp_problem(seed)
        _, ilp_lik = ilp.solve_ilp((0, 2), tensors, pack, bayes, params)
        cfg = SolverConfig(
            anneal_steps=0, polish_steps=0,
            depth_contrib=params.depth_contrib,
            aln_contrib=params.aln_contrib, prob_diff=params.prob_diff,
            tweak=0, window_size=pack.window_size, anneal_steps_b=500,
            move_thin=0.3)
        liks, _ = TB.solve_genotypes(
            seed, np.array([(0, 2)]), tensors.hap_prob, tensors.hap_mid,
            tensors.unmapped_prob, pack.n_windows, pack.reg_start,
            pack.contig_len, pack.gc_at, pack.weight_at, bayes, cfg,
            n_attempts=8, max_windows=pack.max_windows, n_steps=1000,
            device=dev)
        assert liks.device.type == torch.device(dev).type
        best = float(liks.max())
        assert best == pytest.approx(ilp_lik, abs=0.05)
        assert best <= ilp_lik + 0.05


def test_solver_counts_one_launch_a_chunk(card):
    """The call's counters: `k2_chains` holds every chain handed to the
    annealer, `k2_launches` (taken from `_kernels.LAUNCHES`, as `genotype`
    takes it) one launch for each chunk of each stage."""
    from types import SimpleNamespace

    from locityper_tpu_torch import _kernels
    from locityper_tpu_torch.mathx.distr import NBinom
    from locityper_tpu_torch.solvers.solve import Scheme, solve_locus
    from locityper_tpu_torch.utils import spans
    tensors, pack, _, params = ilp_problem(1)
    bg = SimpleNamespace(
        insert_distr=SimpleNamespace(is_paired_end=True),
        depth=SimpleNamespace(distributions=[NBinom(4.0, 0.45)] * 101))
    scheme = Scheme.parse(["greedy:i=5k,a=1", "anneal:i=3,a=4,n=500,p=200"])
    gts = np.array(ALL_GTS, np.int32)
    launches0 = _kernels.LAUNCHES["anneal_chains"]
    with spans.call("genotype") as root:
        solve_locus(tensors, pack, bg, gts, np.zeros(len(gts)), params,
                    scheme, 5, gt_batch=2, device=card)
        spans.count("k2_launches",
                    _kernels.LAUNCHES["anneal_chains"] - launches0)
    stages = [s for s in spans.snapshot()
              if s.call == root.id and s.name.startswith("solve.stage")]
    attempts = {"solve.stage1": 1, "solve.stage2": 4}
    assert root.attrs["k2_launches"] == sum(s.attrs["chunks"]
                                            for s in stages) >= 4
    assert root.attrs["k2_chains"] == sum(
        s.attrs["genotypes"] * attempts[s.name] for s in stages)
