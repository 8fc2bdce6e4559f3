"""PyTorch port of the read-assignment solver vs the JAX package, on the CPU.

Prologue (candidate gather, valid-first permutation, window tables, chain
init): identical numpy inputs through both packages with `tweak=0`, where
every output is deterministic — integers must be equal, floats within 1e-6.
Annealer: the JAX package has no CPU oracle for the dynamics (its Pallas
kernel's generator is stubbed to zeros in interpret mode), so the 0-step path
is compared with that kernel, and the dynamics are held against the exact
ILP optimum and a host re-scoring of the returned assignment.
"""
import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from locityper_tpu.mathx.distr import NBinom
from locityper_tpu.model import Params
from locityper_tpu.model.assgn import LocusTensors
from locityper_tpu.model.windows import ContigInfoPack
from locityper_tpu.ops import solver as JS
from locityper_tpu.ops import solver_pallas as JP
from locityper_tpu_torch import convert
from locityper_tpu_torch.ops import solver as TS
from locityper_tpu_torch.ops import solver_chains as TC
from locityper_tpu_torch.solvers import ilp as TILP
from locityper_tpu_torch.solvers.solve import _unpermute_assignments

# One intra-op thread: the suite runs several workers side by side, and the
# tensors here are small.
torch.set_num_threads(1)


def problem(seed=0, n_reads=40, n_haps=3, kh=3, deep=False):
    """tests/test_ilp.py:small_problem, or with `deep` every candidate
    middle inside ONE window (tests/test_solver_pallas.py:deep_problem:
    window depth ~2·n_reads = 60, above 32 and below d_tab = 64)."""
    rng = np.random.default_rng(seed)
    hap_len = 1500
    if deep:
        n_reads = 30
    hap_prob = rng.normal(-4.0, 2.0, (n_haps, n_reads, kh)).astype(np.float32)
    hap_prob[rng.random((n_haps, n_reads, kh)) < (0.2 if deep else 0.35)] = -1e30
    if deep:
        mid = rng.integers(360, 440, (n_haps, n_reads, kh, 2)).astype(np.int32)
    else:
        mid = rng.integers(0, hap_len, (n_haps, n_reads, kh, 2)).astype(np.int32)
        mid[rng.random((n_haps, n_reads, kh, 2)) < 0.15] = -1
    unm = np.full(n_reads, -30.0, np.float32)
    tensors = LocusTensors(hap_prob, mid, unm, n_haps, n_reads, kh)
    window, n_win = 100, 8
    pack = ContigInfoPack(
        n_haps=n_haps, max_len=hap_len, max_windows=32,
        n_windows=np.full(n_haps, n_win, np.int32),
        reg_start=np.full(n_haps, (hap_len - n_win * window) // 2, np.int32),
        contig_len=np.full(n_haps, hap_len, np.int32),
        window_size=window,
        gc_at=rng.integers(35, 60, (n_haps, hap_len)).astype(np.int32),
        weight_at=rng.uniform(0.6, 1.0, (n_haps, hap_len)).astype(np.float32))
    bayes = JS.build_bayes_table([NBinom(4.0, 0.45)] * 101, [0.3, 2.0, 3.0], 2.0)
    return tensors, pack, bayes, Params(tweak=0)


def solver_args(tensors, pack, bayes):
    return (tensors.hap_prob, tensors.hap_mid, tensors.unmapped_prob,
            pack.n_windows, pack.reg_start, pack.contig_len, pack.gc_at,
            pack.weight_at, bayes)


def cfg_pair(params, pack, **kw):
    base = dict(depth_contrib=params.depth_contrib,
                aln_contrib=params.aln_contrib, prob_diff=params.prob_diff,
                tweak=0, window_size=pack.window_size)
    base.update(kw)
    return JS.SolverConfig(**base), TS.SolverConfig(**base)


def torch_args(tensors, pack, bayes):
    f32, i32 = torch.float32, torch.int32
    dts = (f32, i32, f32, i32, i32, i32, i32, f32, f32)
    return [torch.as_tensor(np.asarray(a)).to(dt)
            for a, dt in zip(solver_args(tensors, pack, bayes), dts)]


ALL_GTS = np.array([(a, b) for a in range(3) for b in range(a, 3)], np.int32)


def test_philox_known_answers():
    """Philox4x32-10 known-answer vectors of the Random123 distribution."""
    kat = [((0, 0, 0, 0), (0, 0),
            (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
           ((0xffffffff,) * 4, (0xffffffff, 0xffffffff),
            (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
           ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
            (0xa4093822, 0x299f31d0),
            (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]
    for ctr, key, want in kat:
        got = TC.philox4x32(*(torch.tensor([c], dtype=torch.int64)
                              for c in ctr), *key)
        assert tuple(int(g[0]) for g in got) == want
    u = TC._u01(torch.tensor([0, 0xffffffff, 0x80000000]))
    assert u.tolist() == [0.0, (2 ** 24 - 1) / 2 ** 24, 0.5]
    r = TC._randint(torch.tensor([0.0, 0.5, 0.99999994]),
                    torch.tensor([7, 7, 7]))
    assert r.tolist() == [0, 3, 6]


@pytest.mark.parametrize("seed", [0, 1])
def test_gather_and_compact_equal(seed):
    tensors, pack, bayes, params = problem(seed)
    args = torch_args(tensors, pack, bayes)
    probs, mids, slots, valid = TS._gather_candidates(
        args[0], args[1], args[2], torch.as_tensor(ALL_GTS), params.prob_diff)
    vorder, vcount = TS._compact_valid(valid)
    for gi, gt in enumerate(ALL_GTS):
        jp, jm, jsl, jv = JS._gather_candidates(
            tensors.hap_prob, tensors.hap_mid, tensors.unmapped_prob, gt,
            params.prob_diff)
        jo, jc = JS._compact_valid(jv)
        np.testing.assert_array_equal(probs[gi].numpy(), np.asarray(jp))
        np.testing.assert_array_equal(mids[gi].numpy(), np.asarray(jm))
        np.testing.assert_array_equal(slots[gi].numpy(), np.asarray(jsl))
        np.testing.assert_array_equal(valid[gi].numpy(), np.asarray(jv))
        np.testing.assert_array_equal(vorder[gi].numpy(), np.asarray(jo))
        np.testing.assert_array_equal(vcount[gi].numpy(), np.asarray(jc))


def test_gather_with_per_haplotype_unmapped_rows():
    """The panel solver passes unmapped_prob as [H, R] rows."""
    tensors, pack, bayes, params = problem(3)
    unm2 = np.stack([tensors.unmapped_prob - h for h in range(3)])
    args = torch_args(tensors, pack, bayes)
    probs, _, _, valid = TS._gather_candidates(
        args[0], args[1], torch.as_tensor(unm2), torch.as_tensor(ALL_GTS),
        params.prob_diff)
    for gi, gt in enumerate(ALL_GTS):
        jp, _, _, jv = JS._gather_candidates(
            tensors.hap_prob, tensors.hap_mid, unm2, gt, params.prob_diff)
        np.testing.assert_array_equal(probs[gi].numpy(), np.asarray(jp))
        np.testing.assert_array_equal(valid[gi].numpy(), np.asarray(jv))


def test_bayes_table_equal():
    distrs = [NBinom(3.0 + 0.05 * i, 0.4) for i in range(101)]
    want = JS.build_bayes_table(distrs, [0.5, 2.0], 2.0)
    got = TS.build_bayes_table(distrs, [0.5, 2.0], 2.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got.shape == (101, TS.DEPTH_CAP) and got.dtype == np.float32
    for name in ("NEG", "UNMAPPED_WINDOW", "BOUNDARY_WINDOW",
                 "REG_WINDOW_SHIFT", "DEPTH_CAP", "MIN_WINDOW_WEIGHT"):
        assert getattr(TS, name) == getattr(JS, name)


@pytest.mark.parametrize("seed,k_eff", [(0, None), (1, 5)])
def test_prepare_chains_equal(seed, k_eff):
    """Every per-chain tensor the annealer is fed, with tweak=0 and argmax
    init: integers equal, floats within 1e-6."""
    tensors, pack, bayes, params = problem(seed)
    jcfg, tcfg = cfg_pair(params, pack)
    A = 2
    want = jax.jit(lambda key, gts, *a: JP._prepare_chains(
        key, gts, A, *a, jcfg, pack.max_windows, False, k_eff=k_eff))(
        jax.random.PRNGKey(seed), ALL_GTS, *solver_args(tensors, pack, bayes))
    (j_probs, j_winpk, j_vcount, j_nt, j_ntc, j_wtab, j_temp, j_assgn0,
     j_depth0, j_cache0) = (np.asarray(x) for x in want)
    gen = torch.Generator().manual_seed(seed)
    got = TC._prepare_chains(
        gen, torch.as_tensor(ALL_GTS).long(), A,
        *torch_args(tensors, pack, bayes), tcfg, pack.max_windows, False,
        k_eff=k_eff)
    (probs, winpk, vcount, nt_ixs, ntc, start_temp, wtab, assgn0, depth0,
     cache0) = (x.numpy() for x in got)
    G, R, K = probs.shape
    C, W, D = wtab.shape
    assert C == G * A and D == tcfg.d_tab and K == (k_eff or 7)
    g_of = np.arange(C) // A
    # The JAX feeds are [K·R, C] k-major and [W·D, C], chain axis last.
    np.testing.assert_array_equal(
        j_probs.reshape(K, R, C).transpose(2, 1, 0), probs[g_of])
    np.testing.assert_array_equal(
        j_winpk.reshape(K, R, C).transpose(2, 1, 0), winpk)
    np.testing.assert_allclose(j_wtab.reshape(W, D, C).transpose(2, 0, 1),
                               wtab, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(j_vcount, vcount[g_of])
    np.testing.assert_array_equal(j_nt, nt_ixs[g_of])
    np.testing.assert_array_equal(j_ntc, ntc[g_of])
    # start_temp ~ 15: one float32 ulp there is 9.5e-7, so this one is
    # held relatively (XLA fuses the multiply-add under jit).
    np.testing.assert_allclose(j_temp, start_temp[g_of], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(j_assgn0, assgn0)
    np.testing.assert_array_equal(j_depth0, depth0)
    np.testing.assert_allclose(j_cache0, cache0, rtol=0, atol=1e-6)


def test_window_tweaks_keep_their_invariants():
    """tweak > 0 draws from another generator than JAX's: hold the codes
    and ranges instead of the values."""
    tensors, pack, bayes, params = problem(4)
    args = torch_args(tensors, pack, bayes)
    gts = torch.as_tensor(ALL_GTS).long().repeat_interleave(3, 0)
    gen = torch.Generator().manual_seed(1)
    probs, mids, slots, _ = TS._gather_candidates(
        args[0], args[1], args[2], gts, params.prob_diff)
    tweak, wsize, mw = 50, pack.window_size, pack.max_windows
    wins = TS._read_windows(gen, gts, mids, slots, args[3], args[4], wsize,
                            tweak, mw)
    wins0 = TS._read_windows(gen, gts, mids, slots, args[3], args[4], wsize,
                             0, mw)
    W = 2 + 2 * mw
    assert wins.dtype == torch.int32 and wins.shape == mids.shape
    assert int(wins.min()) >= 0 and int(wins.max()) < W
    assert bool((wins[mids < 0] == TS.UNMAPPED_WINDOW).all())
    assert bool((wins[mids >= 0] != TS.UNMAPPED_WINDOW).all())
    # A tweak in [0, 2·tweak] moves a middle by at most one window of 100.
    reg = (wins >= 2) & (wins0 >= 2)
    assert int((wins - wins0)[reg].abs().max()) <= 1
    assert bool(((wins - wins0)[reg] >= 0).all())
    # Regular windows of hap copy s live in [2 + s·mw, 2 + s·mw + n_windows).
    off = (wins - 2) - slots[..., None] * mw
    assert bool(((off >= 0) & (off < 8))[wins >= 2].all())
    win_gc, win_weight = TS._window_tables(
        gen, gts, args[3], args[4], args[5], args[6], args[7], wsize, tweak,
        mw)
    assert win_gc.shape == (gts.shape[0], W) == win_weight.shape
    assert bool((win_weight[:, :2] == 0).all())
    ww = win_weight[:, 2:].reshape(-1, 2, mw)
    assert bool((ww[:, :, 8:] == 0).all()) and bool((ww[:, :, :8] > 0).all())
    assert int(win_gc.min()) >= 0 and int(win_gc.max()) <= 100
    # Different attempts of one genotype see different tweaked tables.
    assert not torch.equal(win_gc[0], win_gc[1])


def run_pallas(seed, gts, tensors, pack, bayes, cfg, **kw):
    with pltpu.force_tpu_interpret_mode():
        liks, assgn = JP.solve_genotypes_pallas(
            jax.random.PRNGKey(seed), gts, *solver_args(tensors, pack, bayes),
            cfg, **kw)
    return np.asarray(liks), np.asarray(assgn)


def run_torch(seed, gts, tensors, pack, bayes, cfg, **kw):
    liks, assgn = TC.solve_genotypes(
        seed, gts, *solver_args(tensors, pack, bayes), cfg, device="cpu",
        **kw)
    return liks.numpy(), assgn.numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_zero_steps_match_pallas_kernel_above_depth_32(seed):
    """0 steps, argmax init, tweak=0: likelihood within 1e-3 (float32 sums
    in another order) and assignments equal, at window depth ~60."""
    tensors, pack, bayes, params = problem(seed, deep=True)
    jcfg, tcfg = cfg_pair(params, pack, anneal_steps=0, polish_steps=0)
    kw = dict(n_attempts=2, max_windows=pack.max_windows, n_steps=0,
              random_init=False)
    want, w_assgn = run_pallas(seed, ALL_GTS, tensors, pack, bayes, jcfg, **kw)
    got, g_assgn = run_torch(seed, ALL_GTS, tensors, pack, bayes, tcfg, **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(g_assgn, w_assgn)


def test_d_tab_clamp_is_kept():
    """With d_tab=32 the depth-60 window saturates: the port must then
    diverge from the XLA engine (DEPTH_CAP=256) exactly as the Pallas
    kernel does, and agree with that kernel."""
    tensors, pack, bayes, params = problem(0, deep=True)
    gt = np.array([(0, 2)], np.int32)
    jcfg, tcfg = cfg_pair(params, pack, anneal_steps=0, polish_steps=0,
                          d_tab=32)
    kw = dict(n_attempts=1, max_windows=pack.max_windows, random_init=False)
    xla, _ = JS.solve_genotypes(
        jax.random.PRNGKey(0), gt, *solver_args(tensors, pack, bayes), jcfg,
        **kw)
    pal, _ = run_pallas(0, gt, tensors, pack, bayes, jcfg, n_steps=0, **kw)
    got, _ = run_torch(0, gt, tensors, pack, bayes, tcfg, n_steps=0, **kw)
    assert abs(float(got[0, 0]) - float(np.asarray(xla)[0, 0])) > 1e-3
    assert float(got[0, 0]) == pytest.approx(float(pal[0, 0]), abs=1e-3)


def test_init_assgn_plumbing_and_plato_off():
    """Seeding with the argmax rows reproduces random_init=False at 0
    steps; plato >= n_steps equals the fixed-step walk."""
    tensors, pack, bayes, params = problem(2, deep=True)
    gt = np.array([(0, 1)], np.int32)
    _, tcfg = cfg_pair(params, pack, anneal_steps=0, polish_steps=0)
    kw = dict(n_attempts=2, max_windows=pack.max_windows, n_steps=0)
    base, assgn = run_torch(2, gt, tensors, pack, bayes, tcfg,
                            random_init=False, **kw)
    seeded, assgn2 = run_torch(99, gt, tensors, pack, bayes, tcfg,
                               random_init=True, init_assgn=assgn, **kw)
    np.testing.assert_array_equal(seeded, base)
    np.testing.assert_array_equal(assgn2, assgn)
    _, pcfg = cfg_pair(params, pack, anneal_steps=0, polish_steps=300)
    kw = dict(n_attempts=2, max_windows=pack.max_windows, n_steps=300,
              random_init=True)
    a, aa = run_torch(5, gt, tensors, pack, bayes, pcfg, plato=300, **kw)
    b, ba = run_torch(5, gt, tensors, pack, bayes, pcfg, plato=0, **kw)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(aa, ba)
    c, _ = run_torch(5, gt, tensors, pack, bayes, pcfg, plato=20, **kw)
    assert np.isfinite(c).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_annealer_reaches_ilp_optimum(seed):
    """Dynamics: the best of 128 chains equals the exact ILP optimum within
    1e-3 (float32 likelihood of magnitude ~50 against a float64 optimum;
    tests/test_ilp.py allows 5e-2), never beats it, and every reported
    likelihood equals a float64 host re-scoring of the returned,
    un-permuted assignment within 1e-3.  Same seed, same result."""
    tensors, pack, bayes, params = problem(seed)
    t_tensors, t_pack = (convert.from_reference(tensors),
                         convert.from_reference(pack))
    gt = (0, 2)
    _, ilp_lik = TILP.solve_ilp(gt, t_tensors, t_pack, bayes, params)
    _, tcfg = cfg_pair(params, pack, anneal_steps=1200, polish_steps=600)
    kw = dict(n_attempts=128, max_windows=pack.max_windows, plato=600)
    gts = np.array([gt], np.int32)
    liks, assgn = run_torch(seed, gts, tensors, pack, bayes, tcfg, **kw)
    best = float(liks.max())
    assert best == pytest.approx(ilp_lik, abs=1e-3), (best, ilp_lik)
    assert best <= ilp_lik + 1e-3

    probs, wins, valid, win_gc, win_weight = TILP.assemble_genotype_host(
        gt, t_tensors, t_pack, bayes, params.prob_diff)
    orig = _unpermute_assignments(assgn, gts, t_tensors, params)
    for a in range(0, 128, 16):
        assert valid[np.arange(orig.shape[2]), orig[0, a]].all()
        host = TILP.likelihood_of_assignment(
            orig[0, a], probs, wins, win_gc, win_weight, bayes,
            params.depth_contrib, params.aln_contrib)
        assert float(liks[0, a]) == pytest.approx(host, abs=1e-3)

    liks2, assgn2 = run_torch(seed, gts, tensors, pack, bayes, tcfg, **kw)
    np.testing.assert_array_equal(liks, liks2)
    np.testing.assert_array_equal(assgn, assgn2)
    liks3, _ = run_torch(seed + 100, gts, tensors, pack, bayes, tcfg, **kw)
    assert not np.array_equal(liks, liks3)


# ---------------------------------------------------------------------------
# The CUDA kernel's schedule, modelled on the CPU: one chain walked in batches
# of 32 steps.  Every lane of a batch evaluates its move against the state at
# the start of the batch; then all lanes up to the first one that an accepted
# earlier lane disturbs (same read, or a window whose depth both moves
# change) are settled at once, the accepted ones apply their moves together,
# and the disturbed later lanes evaluate again.  The walk must equal the
# step-by-step plain annealer exactly.
# ---------------------------------------------------------------------------

def random_chains(seed, G=3, A=2, R=12, K=4, W=8, D=16):
    """Small random chain tensors (numpy seed), few windows so that moves
    of one batch conflict often."""
    rng = np.random.default_rng(seed)
    C = G * A
    probs = (-4 * rng.random((G, R, K))).astype(np.float32)
    w = rng.integers(0, W, (C, R, K, 2)).astype(np.int32)
    winpk = w[..., 0] | (w[..., 1] << 16)
    vcount = rng.integers(1, K + 1, (G, R)).astype(np.int32)
    nontrivial = vcount > 1
    nt_ixs = np.argsort(~nontrivial, axis=1, kind="stable").astype(np.int32)
    ntc = np.maximum(nontrivial.sum(1), 1).astype(np.int32)
    start_temp = np.full(G, 2.0, np.float32)
    wtab = (-rng.random((C, W, D))).astype(np.float32)
    assgn0 = np.zeros((C, R), np.int32)
    depth0 = np.zeros((C, W), np.int32)
    for c in range(C):
        np.add.at(depth0[c], w[c, :, 0, 0], 1)
        np.add.at(depth0[c], w[c, :, 0, 1], 1)
    cache0 = np.take_along_axis(wtab, np.clip(depth0, 0, D - 1)[..., None],
                                axis=2)[..., 0]
    return tuple(torch.from_numpy(x) for x in (
        probs, winpk, vcount, nt_ixs, ntc, start_temp, wtab, assgn0, depth0,
        cache0))


def walk_chain_in_batches(c, probs, winpk, vcount, nt_ixs, ntc, start_temp,
                          wtab, assgn, depth, cache, *, attempts, n_steps,
                          anneal_steps, dc, ac, plato, ln_init_prob, seed):
    """Walks chain `c` as one warp of the kernel does; updates the chain's
    rows of assgn/depth/cache in place.  Returns (steps_done, evaluation
    rounds, batches)."""
    R, K = winpk.shape[1:]
    D = wtab.shape[2]
    f32, i64 = torch.float32, torch.int64
    g = c // attempts
    st = start_temp[g].to(f32)
    plato = plato if plato and plato < n_steps else 0
    min_diff = torch.clamp_min(st * float(np.float32(-ln_init_prob)) * 1e-6,
                               1e-10) if plato else None
    k0, k1 = TC._split_seed(seed)
    denom = float(max(anneal_steps, 1))
    as_, dp, ch = assgn[c], depth[c], cache[c]
    lanes = torch.arange(32, dtype=i64)
    stale, rounds, batches = 0, 0, 0

    for s0 in range(0, n_steps, 32):
        nvalid = min(32, n_steps - s0)
        steps = s0 + lanes
        zero = torch.zeros(32, dtype=i64)
        b0, b1, b2, _ = TC.philox4x32(torch.full((32,), c, dtype=i64), steps,
                                      zero, zero, k0, k1)
        # Independent of the state: one lane a step.
        t = TC._randint(TC._u01(b0), ntc[g].to(i64).expand(32))
        r = nt_ixs[g].to(i64)[t]
        vc = vcount[g].to(i64)[r]
        i = 1 + TC._randint(TC._u01(b1), torch.clamp_min(vc - 1, 1))
        u = TC._u01(b2)
        s_rem = torch.clamp_min(anneal_steps - steps, 0).to(f32)
        temp = st * s_rem / denom
        hot = steps < anneal_steps

        accept = torch.zeros(32, dtype=torch.bool)
        new = torch.zeros(32, dtype=i64)
        ws = torch.zeros((32, 4), dtype=i64)
        cs = torch.zeros((32, 4), dtype=i64)
        new_v = torch.zeros((32, 4), dtype=f32)

        def evaluate(m):
            """Lanes `m` evaluate their move against the current state."""
            cur = as_.to(i64)[r[m]]
            nw = torch.where(i[m] <= cur, i[m] - 1, i[m])
            p_cur = probs[g, r[m], cur]
            p_new = probs[g, r[m], nw]
            wp_cur = winpk[c, r[m], cur].to(i64)
            wp_new = winpk[c, r[m], nw].to(i64)
            w1, w2 = wp_cur & TC.M16, (wp_cur >> 16) & TC.M16
            w3, w4 = wp_new & TC.M16, (wp_new >> 16) & TC.M16
            e21 = w2 == w1
            c1 = -1 - e21.to(i64)
            c2 = e21.to(i64) - 1
            e31, e32 = w3 == w1, w3 == w2
            c3 = 1 - (e31 | e32).to(i64)
            c1 = c1 + e31.to(i64)
            c2 = c2 + (~e31 & e32).to(i64)
            e41, e42, e43 = w4 == w1, w4 == w2, w4 == w3
            c4 = 1 - (e41 | e42 | e43).to(i64)
            c1 = c1 + e41.to(i64)
            c2 = c2 + (~e41 & e42).to(i64)
            c3 = c3 + (~e41 & ~e42 & e43).to(i64)
            wv = torch.stack([w1, w2, w3, w4], dim=1)
            cv = torch.stack([c1, c2, c3, c4], dim=1)
            d1 = torch.clamp(dp.to(i64)[wv] + cv, 0, D - 1)
            nv = wtab[c][wv, d1]
            dd = torch.where(cv != 0, nv - ch[wv], 0.0)
            delta = ac * (p_new - p_cur) \
                + dc * (dd[:, 0] + dd[:, 1] + dd[:, 2] + dd[:, 3])
            if plato:
                diffm = delta - min_diff
                metro = (temp[m] > 0) & (u[m] <= torch.exp(
                    diffm / torch.clamp_min(temp[m], 1e-30)))
                acc = torch.where(hot[m], (diffm >= 0) | metro,
                                  delta > min_diff)
            else:
                metro = (temp[m] > 0) & (u[m] <= torch.exp(
                    delta / torch.clamp_min(temp[m], 1e-30)))
                acc = (delta >= 0) | metro
            accept[m], new[m], ws[m], cs[m], new_v[m] = acc, nw, wv, cv, nv

        def disturbs(x, y):
            """Applying lane y's move changes what lane x evaluated: the
            same read, or a window whose depth both moves change."""
            changed, needed = ws[y][cs[y] != 0], ws[x][cs[x] != 0]
            return bool(r[x] == r[y]) or bool(
                (needed[:, None] == changed[None, :]).any())

        pend = [lane < nvalid for lane in range(32)]
        pos = 0
        while pos < nvalid:
            evaluate(torch.tensor(pend))
            rounds += 1
            # Every lane up to the first one that an accepted earlier lane
            # of this stretch disturbs is settled at once.
            f = next((x for x in range(pos, nvalid)
                      if any(accept[y] and disturbs(x, y)
                             for y in range(pos, x))), nvalid)
            moved = [x for x in range(pos, f) if accept[x]]
            # Rejections add to `stale`, an accepted move sets it to 0, and
            # the chain freezes before the step at which it reaches `plato`.
            run_from, stop = pos, None
            for a in moved + [f]:
                if plato and run_from + (plato - stale) <= a:
                    stop = run_from + (plato - stale)
                    moved = [x for x in moved if x < stop]
                    break
                if a < f:
                    run_from, stale = a + 1, 0
            if stop is None:
                stale += f - run_from
            written = set()
            for a in moved:                 # together: no word written twice
                for q in range(4):
                    if cs[a, q] != 0:
                        assert ("w", int(ws[a, q])) not in written
                        written.add(("w", int(ws[a, q])))
                        dp[ws[a, q]] = dp[ws[a, q]] + cs[a, q]
                        ch[ws[a, q]] = new_v[a, q]
                assert ("r", int(r[a])) not in written
                written.add(("r", int(r[a])))
                as_[r[a]] = new[a]
            if stop is not None:            # the chain freezes before `stop`
                return s0 + stop, rounds, batches + 1
            pend = [x >= f and x < nvalid
                    and any(disturbs(x, y) for y in moved)
                    for x in range(32)]
            pos = f
        batches += 1
    return n_steps, rounds, batches


@pytest.mark.parametrize("anneal_steps", [0, 40])
@pytest.mark.parametrize("n_steps", [0, 31, 100])
@pytest.mark.parametrize("plato", [0, 5, 40, 300])
def test_batched_schedule_equals_plain_annealer(plato, n_steps, anneal_steps):
    """Assignments, likelihoods and step counts of the batched walk equal
    `anneal_chains_reference` exactly, whatever the plateau, for step
    counts that are no multiple of 32 and a cooling phase that ends inside a
    batch."""
    args = random_chains(17)
    kw = dict(attempts=2, n_steps=n_steps, anneal_steps=anneal_steps,
              dc=1.85, ac=0.15, plato=plato, ln_init_prob=-0.6931472, seed=5)
    want_lik, want_assgn, want_steps = TC.anneal_chains_reference(*args, **kw)
    probs, winpk = args[0], args[1]
    C, A = winpk.shape[0], kw["attempts"]
    assgn, depth, cache = (x.clone() for x in args[7:])
    steps, rounds, batches = [], 0, 0
    for c in range(C):
        s, n_r, n_b = walk_chain_in_batches(c, *args[:7], assgn, depth, cache,
                                            **kw)
        steps.append(s)
        rounds, batches = rounds + n_r, batches + n_b
    assert steps == want_steps.tolist()
    assert torch.equal(assgn, want_assgn)
    g = torch.arange(C) // A
    dep = cache.double().sum(dim=1).to(torch.float32)
    aln = torch.gather(probs[g], 2, assgn.long()[:, :, None])[:, :, 0] \
        .double().sum(dim=1).to(torch.float32)
    assert torch.equal(kw["dc"] * dep + kw["ac"] * aln, want_lik)
    assert rounds >= batches
    if n_steps == 100 and plato in (0, 300):
        # Several moves of a batch are accepted: some batches take more
        # than one round, none takes 32.
        assert batches == 4 * C and batches < rounds < 32 * batches
