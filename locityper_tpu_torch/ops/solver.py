"""Read-assignment solver: shared prologue and the sequential engine.

Model recap (model/assgn.rs):
  total = depth_contrib · Σ_w weight[w]·lnBayes(depth[w])
        + aln_contrib   · Σ_r ln_prob[r, assignment[r]]
A move changes one read's location: Δ touches ≤4 windows (assgn.rs:259-284)
and one alignment probability.

Genotype assembly is pure gathers (extend_read_gt_alns, windows.rs:762-797):
candidates of the genotype's haplotypes + the unmapped state, thresholded at
best − prob_diff.  Read→window mapping and per-attempt window tweaks
(assgn.rs:127-151) are index arithmetic into per-haplotype characteristic
arrays (model/windows.py).

Every function here is batched: `gts` is [G, P] (or [C, P] once repeated per
attempt) and the outputs carry that leading axis.  Two engines run on these
tensors.  The parallel-chains annealer (hand-written kernel on the card)
lives in ops/solver_chains.py.  The sequential engine (`e=seq`) is here:
`_chain` (one annealing chain: Metropolis under linear cooling, then polish
steps that accept no loss) and `_greedy_chain` (the reference greedy,
stoch.rs:36-145: sample reads, take the single best improving move, stop on
a plateau), each in plain PyTorch vectorised over the chains of a call with
a Python loop over steps, on either device.  Its random numbers come from
the counter-based Philox4x32-10 of ops/solver_chains.py, counted by
(genotype row, attempt, step or iteration, draw), so that a chain's walk
depends neither on the other chains of its call nor on the device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import _kernels

NEG = -1e30
UNMAPPED_WINDOW = 0
BOUNDARY_WINDOW = 1
REG_WINDOW_SHIFT = 2
DEPTH_CAP = 256
MIN_WINDOW_WEIGHT = 1e-7   # distr_cache.rs:84-92


@dataclass(frozen=True)
class SolverConfig:
    anneal_steps: int = 20000
    polish_steps: int = 10000
    init_prob: float = 0.5
    depth_contrib: float = 1.85
    aln_contrib: float = 0.15
    prob_diff: float = 4.605
    tweak: int = 50
    window_size: int = 100
    # Batched-move engine (ops/solver_batched.py, `e=batched`): cooling
    # super-steps and the share of accepted moves kept a super-step.
    anneal_steps_b: int = 500
    move_thin: float = 0.3
    # Depth-table height of the annealer (ops/solver_chains.py).  Depths
    # above this clamp to the last row; the sequential engine and the exact
    # ILP oracle score with DEPTH_CAP=256.
    d_tab: int = 64
    # Reference greedy of the sequential engine (stoch.rs:36-145): when
    # greedy_sample > 0, `_greedy_chain` samples that many non-trivial reads
    # per iteration, applies the single best improving reassignment, and
    # stops after plato_size iterations without one.
    greedy_sample: int = 0
    plato_size: int = 100


def _gather_candidates(hap_prob, hap_mid, unmapped_prob, gts, prob_diff):
    """Candidates of genotypes gts [G, P]: [G, R, K = P·Kh + 1] tensors.
    Last slot is the all-unmapped state (windows.rs:762-797; the reference
    supports arbitrary ploidy, genotype.rs:1077-1108).

    unmapped_prob: [R], or [H, R] per-haplotype rows (multi-locus panel
    solving shares the read axis across loci; each locus's haplotype rows
    carry its own unmapped penalties — solvers/solve.py:solve_panel).
    Returns (probs, mids [G, R, K, 2], slots [G, R, K], valid)."""
    gts = gts.long()
    G, P = gts.shape
    ps = [hap_prob[gts[:, s]] for s in range(P)]         # each [G, R, Kh]
    ms = [hap_mid[gts[:, s]] for s in range(P)]          # each [G, R, Kh, 2]
    if unmapped_prob.ndim == 2:
        unm = unmapped_prob[gts[:, 0]]                   # [G, R]
    else:
        unm = unmapped_prob[None, :].expand(G, -1)
    R = ps[0].shape[1]
    dev = hap_prob.device
    probs = torch.cat(ps + [unm[:, :, None]], dim=2)
    mids = torch.cat(ms + [torch.full((G, R, 1, 2), -1, dtype=ms[0].dtype,
                                      device=dev)], dim=2)
    slots = torch.cat(
        [torch.full(p.shape, s, dtype=torch.int32, device=dev)
         for s, p in enumerate(ps)]
        + [torch.zeros((G, R, 1), dtype=torch.int32, device=dev)], dim=2)
    # Threshold: max(unmapped, best per hap) - prob_diff.
    best = unm
    for p in ps:
        best = torch.maximum(best, p.amax(dim=2))
    thresh = best - prob_diff
    valid = probs >= thresh[:, :, None]
    # The unmapped candidate stays valid as a fallback if nothing else is.
    probs = torch.where(valid, probs, NEG)
    return probs, mids, slots, valid


def _compact_valid(valid):
    """Per read: indices of valid candidates moved to the front (stable
    order) + count."""
    order = torch.argsort((~valid).to(torch.uint8), dim=-1, stable=True)
    count = valid.sum(dim=-1)
    return order.to(torch.int32), count.to(torch.int32)


def _window_tables(gen, gts, pack_nwin, pack_regstart, pack_len, gc_at,
                   weight_at, wsize, tweak, max_windows, u=None):
    """Per-attempt tweaked window characteristics for chains gts [C, P].
    The shifts come from `u` [C, P, max_windows] uniforms in [0, 1) when
    given, else from the generator `gen`.

    Returns (win_gc [C, W] int64, win_weight [C, W] f32) with
    W = 2 + P·max_windows; slots 0/1 (unmapped/boundary) have weight 0
    (trivial).  Window i of hap copy s has a random start shift in
    [-min(tweak,start), +min(tweak, len-end)] (windows.rs:478-486)."""
    gts = gts.long()
    C, P = gts.shape
    dev = gc_at.device
    ar = torch.arange(max_windows, device=dev)
    starts = pack_regstart[gts].long()[:, :, None] + wsize * ar   # [C, P, mw]
    ends = starts + wsize
    plen = pack_len[gts].long()[:, :, None]
    left = torch.clamp(starts, max=tweak)
    right = torch.clamp(torch.clamp(plen - ends, min=0), max=tweak)
    if u is None:
        u = torch.rand((C, P, max_windows), generator=gen, device=dev,
                       dtype=torch.float32)
    shift = torch.floor(u * (left + right + 1).float()).long() - left
    pos = torch.minimum(torch.clamp(starts + shift, min=0), plen - 1)
    h = gts[:, :, None].expand(C, P, max_windows)
    gc = gc_at[h, pos].long()
    wt = weight_at[h, pos]
    active = ar < pack_nwin[gts].long()[:, :, None]
    wt = torch.where(active, wt, 0.0)
    wt = torch.where(wt < MIN_WINDOW_WEIGHT, 0.0, wt)
    win_gc = torch.zeros((C, 2 + P * max_windows), dtype=torch.int64,
                         device=dev)
    win_weight = torch.zeros((C, 2 + P * max_windows), dtype=torch.float32,
                             device=dev)
    win_gc[:, 2:] = gc.reshape(C, -1)
    win_weight[:, 2:] = wt.reshape(C, -1)
    return win_gc, win_weight


def _read_windows(gen, gts, mids, slots, pack_nwin, pack_regstart, wsize,
                  tweak, max_windows, t=None):
    """Maps candidate middles to window indices with per-candidate random
    tweaks (define_windows_random, windows.rs:123-136).  gts [C, P],
    mids [C, R, K, 2], slots [C, R, K] -> wins [C, R, K, 2] int32.  The
    tweaks are `t` [C, R, K, 2] in [0, 2·tweak] when given, else drawn from
    the generator `gen`."""
    gts = gts.long()
    C, R, K, _ = mids.shape
    dev = mids.device
    if tweak > 0:
        if t is None:
            t = torch.randint(0, 2 * tweak + 1, (C, R, K, 2), generator=gen,
                              device=dev, dtype=torch.int32)
        m = mids + t
    else:
        m = mids
    h = torch.gather(gts, 1, slots.reshape(C, R * K).long()).view(C, R, K)
    n = pack_nwin[h].to(torch.int32)[..., None]
    reg = pack_regstart[h].to(torch.int32)[..., None]
    wshift = (REG_WINDOW_SHIFT + slots * max_windows)[..., None]
    w = torch.div(m - reg, wsize, rounding_mode="floor")
    inside = (m >= reg) & (w >= 0) & (w < n)
    win = torch.where(inside, w + wshift, BOUNDARY_WINDOW)
    win = torch.where(mids < 0, UNMAPPED_WINDOW, win)
    return win.to(torch.int32)


# ---------------------------------------------------------------------------
# The sequential engine (e=seq)
# ---------------------------------------------------------------------------

#: Kinds of draw: the fourth counter word of the engine's Philox draws.
(_DRAW_WINDOWS, _DRAW_READ_WINDOWS, _DRAW_INIT, _DRAW_PROBE, _DRAW_STEP,
 _DRAW_GREEDY) = range(6)
N_PROBES = 100          # random moves that set the scale (stoch.rs:19-29)
STOP_CHECK = 64         # greedy iterations between two looks at "all stopped"


def _at(x, w):
    """x [C, W] at per-chain indices w [C, ...] -> [C, ...]."""
    return torch.gather(x, 1, w.reshape(w.shape[0], -1)).view(w.shape)


def _depth_lik_terms(bayes, win_gc, win_weight, depth):
    """weight·lnBayes of every window at its depth, clamped to
    DEPTH_CAP - 1 (tensors of one shape)."""
    d = torch.clamp(depth, max=DEPTH_CAP - 1).long()
    return win_weight * bayes[win_gc.long(), d]


def _ln_depth(bayes, win_gc, win_weight, w, d):
    """weight·lnBayes at windows w [C, ...] and depths d of the same shape
    (WindowDistr::ln_prob); win_gc, win_weight [C, W]."""
    d = torch.clamp(d, 0, DEPTH_CAP - 1)
    return _at(win_weight, w) \
        * bayes.reshape(-1)[_at(win_gc, w) * bayes.shape[1] + d]


def _depth_lik_diff(bayes, win_gc, win_weight, depth, w1, w2, w3, w4):
    """Exact 4-window depth delta with shared-window handling
    (assgn.rs:259-284): depth at w1, w2 −1, at w3, w4 +1.  The windows are
    int64 [C, ...] (broadcast to one shape); win_gc, win_weight, depth
    [C, W].  The reference's cascade gives each distinct window its net
    change (−1 for each of w1, w2 it equals, +1 for each of w3, w4) at its
    first position among the four, and 0 at a repeat; the four terms are
    summed in the order w1, w2, w3, w4."""
    ws = torch.stack(torch.broadcast_tensors(w1, w2, w3, w4), dim=-1)
    same = ws[..., :, None] == ws[..., None, :]                  # [..., 4, 4]
    net = same[..., 2:].sum(dim=-1) - same[..., :2].sum(dim=-1)
    cs = torch.where(same.tril(-1).any(dim=-1), 0, net)
    d0 = _at(depth, ws)
    # One gather for the new and the old depth terms of the four windows.
    ln = _ln_depth(bayes, win_gc, win_weight, torch.cat([ws, ws], dim=-1),
                   torch.cat([d0 + cs, d0], dim=-1))
    atomic = torch.where(cs == 0, 0.0, ln[..., :4] - ln[..., 4:])
    return atomic[..., 0] + atomic[..., 1] + atomic[..., 2] + atomic[..., 3]


class _Draws:
    """Philox4x32-10 draws of the chains of one call: keyed by the call's
    seed, counted by (genotype row, attempt, index, kind of draw).  Chains
    are genotype-major: chain c is attempt c % attempts of row
    rows[c // attempts]."""

    def __init__(self, seed: int, rows, attempts: int):
        # ops/solver_chains.py imports this module: import it at use.
        from . import solver_chains
        self._sc = solver_chains
        self.k0, self.k1 = solver_chains._split_seed(seed)
        self.row = torch.repeat_interleave(rows, attempts)
        self.att = torch.arange(attempts, device=rows.device) \
            .repeat(rows.numel())

    def uniforms(self, idx, kind):
        """Four [C, n] float32 tensors in [0, 1) for the n indices `idx`
        (int64, the same for every chain); `kind` is an int, or an int64
        tensor of idx's shape (a kind for each index)."""
        shape = (self.row.numel(), idx.numel())
        kind = torch.as_tensor(kind, dtype=torch.int64, device=idx.device)
        words = self._sc.philox4x32(
            self.row[:, None].expand(shape), self.att[:, None].expand(shape),
            idx.reshape(1, -1).expand(shape),
            kind.reshape(1, -1).expand(shape), self.k0, self.k1)
        return [self._sc._u01(w) for w in words]

    def randint(self, u, bound):
        """Integers in [0, bound) from uniforms u (bound int64, > 0)."""
        return self._sc._randint(u, bound)


@dataclass
class _SeqProblem:
    """Inputs of the sequential chains of one call (C = G·attempts chains,
    genotype-major; integers int64).  Per genotype: probs [G, R, K] f32 (NEG
    at invalid candidates, original slot order), vorder [G, R, K] (valid
    candidates first, stable), vpos (its inverse), vcount [G, R], nt_ixs
    [G, R] (non-trivial reads first, stable), ntc [G] (their count).  Per
    chain: wins [C, R, K, 2], win_gc, win_weight [C, W].  The rest are
    offsets into the flattened tensors that every step uses."""
    probs: torch.Tensor
    vorder: torch.Tensor
    vpos: torch.Tensor
    vcount: torch.Tensor
    nt_ixs: torch.Tensor
    ntc: torch.Tensor
    wins: torch.Tensor
    win_gc: torch.Tensor
    win_weight: torch.Tensor
    bayes: torch.Tensor
    g: torch.Tensor             # [C] genotype of each chain
    g_r: torch.Tensor           # [C, 1] g·R
    g_rk: torch.Tensor          # [C, 1] g·R·K
    c_rk: torch.Tensor          # [C, 1] c·R·K
    n_reads: torch.Tensor       # [C, 1] max(ntc[g], 1): reads to draw from
    sign: torch.Tensor          # [4] depth change of w1, w2, w3, w4


def _seq_problem(draws, gts, attempts, hap_prob, hap_mid, unmapped_prob,
                 pack_nwin, pack_regstart, pack_len, gc_at, weight_at, bayes,
                 cfg: SolverConfig, max_windows: int) -> _SeqProblem:
    """The prologue of the reference's `_eval_genotype` (ops/solver.py:
    407-431) for genotypes gts [G, P], with the window tweaks of every
    attempt drawn from `draws`."""
    dev = hap_prob.device
    probs, mids, slots, valid = _gather_candidates(
        hap_prob, hap_mid, unmapped_prob, gts, cfg.prob_diff)
    vorder, vcount = _compact_valid(valid)
    vorder, vcount = vorder.long(), vcount.long()
    nontrivial = vcount > 1
    nt_ixs = torch.argsort((~nontrivial).to(torch.uint8), dim=1, stable=True)
    G, R, K = probs.shape
    P = gts.shape[1]
    C = G * attempts
    vpos = torch.empty_like(vorder).scatter_(
        2, vorder, torch.arange(K, device=dev).expand(G, R, K))

    def rep(x):
        return torch.repeat_interleave(x, attempts, dim=0)

    gts_c = rep(gts)
    u = draws.uniforms(torch.arange(P * max_windows, device=dev),
                       _DRAW_WINDOWS)[0].view(C, P, max_windows)
    win_gc, win_weight = _window_tables(
        None, gts_c, pack_nwin, pack_regstart, pack_len, gc_at, weight_at,
        cfg.window_size, cfg.tweak, max_windows, u=u)
    t = None
    if cfg.tweak > 0:
        bound = torch.tensor(2 * cfg.tweak + 1, device=dev)
        u0, u1, _, _ = draws.uniforms(torch.arange(R * K, device=dev),
                                      _DRAW_READ_WINDOWS)
        t = torch.stack([draws.randint(u0, bound), draws.randint(u1, bound)],
                        dim=-1).view(C, R, K, 2).to(torch.int32)
    wins = _read_windows(None, gts_c, rep(mids), rep(slots), pack_nwin,
                         pack_regstart, cfg.window_size, cfg.tweak,
                         max_windows, t=t)
    ntc = nontrivial.sum(dim=1)
    g = torch.arange(C, device=dev) // attempts
    return _SeqProblem(
        probs=probs, vorder=vorder, vpos=vpos, vcount=vcount, nt_ixs=nt_ixs,
        ntc=ntc, wins=wins.long(), win_gc=win_gc, win_weight=win_weight,
        bayes=bayes, g=g, g_r=g[:, None] * R, g_rk=g[:, None] * (R * K),
        c_rk=torch.arange(C, device=dev)[:, None] * (R * K),
        n_reads=torch.clamp_min(ntc[g], 1)[:, None],
        sign=torch.tensor([-1, -1, 1, 1], device=dev))


def _init_assignment(draws, prob: _SeqProblem, random_init: bool):
    """A random valid candidate of every read, or its best one (the first
    maximum: invalid candidates are NEG)."""
    R = prob.probs.shape[1]
    if random_init:
        u = draws.uniforms(torch.arange(R, device=prob.g.device),
                           _DRAW_INIT)[0]
        pick = draws.randint(u, prob.vcount[prob.g])
        return torch.gather(prob.vorder[prob.g], 2, pick[:, :, None])[:, :, 0]
    return prob.probs.argmax(dim=2)[prob.g]


def _depth_of(prob: _SeqProblem, assgn):
    """Read depth of every window [C, W] under assignments assgn [C, R]."""
    C, R = assgn.shape
    w = torch.gather(prob.wins, 2, assgn[:, :, None, None].expand(C, R, 1, 2))
    depth = torch.zeros(prob.win_gc.shape, dtype=torch.int64,
                        device=assgn.device)
    return depth.scatter_add_(1, w.reshape(C, 2 * R),
                              torch.ones((C, 2 * R), dtype=torch.int64,
                                         device=assgn.device))


def _sample_reads(draws, prob: _SeqProblem, u):
    """Non-trivial reads [C, n] drawn uniformly (with replacement) by the
    uniforms u [C, n]; with none, read nt_ixs[0]."""
    t = draws.randint(u, prob.n_reads)
    return prob.nt_ixs.reshape(-1)[prob.g_r + t]


def _propose(draws, prob: _SeqProblem, assgn, depth, u_read, u_cand, dc,
             ac):
    """Random moves from the current state, n per chain (u_read, u_cand
    [C, n]): a random non-trivial read and a random other valid candidate
    of it (ReassignmentTarget::random).  Returns r, old, new, the windows
    [C, n, 4] (w1, w2 of old, w3, w4 of new) and delta = ac·Δaln +
    dc·Δdepth, [C, n] each."""
    K = prob.probs.shape[2]
    r = _sample_reads(draws, prob, u_read)
    old = torch.gather(assgn, 1, r)
    rk = r * K
    gix = prob.g_rk + rk                    # (g·R + r)·K
    n_valid = prob.vcount.reshape(-1)[prob.g_r + r]
    old_pos = prob.vpos.reshape(-1)[gix + old]
    i = 1 + draws.randint(u_cand, torch.clamp_min(n_valid, 2) - 1)
    new = prob.vorder.reshape(-1)[
        gix + torch.where(i <= old_pos, i - 1, i)]
    cix = prob.c_rk + rk                    # (c·R + r)·K
    pairs = prob.wins.view(-1, 2)
    ws = torch.cat([pairs[cix + old], pairs[cix + new]], dim=-1)
    pf = prob.probs.reshape(-1)
    d_aln = pf[gix + new] - pf[gix + old]
    d_dep = _depth_lik_diff(prob.bayes, prob.win_gc, prob.win_weight, depth,
                            *ws.unbind(-1))
    return r, old, new, ws, ac * d_aln + dc * d_dep


def _apply(prob: _SeqProblem, assgn, depth, r, old, new, ws, accept):
    """Moves read r [C, 1] from slot old to new, windows ws [C, 1, 4],
    where accept [C, 1]."""
    C = assgn.shape[0]
    assgn.scatter_(1, r, torch.where(accept, new, old))
    depth.scatter_add_(1, ws.view(C, 4),
                       accept.long() * prob.sign)


def _max_probe(draws, prob, assgn, depth, dc, ac):
    """max |delta| of N_PROBES random moves from the start state [C]
    (stoch.rs:19-29); a probe does not move the chain."""
    u = draws.uniforms(torch.arange(N_PROBES, device=assgn.device),
                       _DRAW_PROBE)
    delta = _propose(draws, prob, assgn, depth, u[0], u[1], dc, ac)[-1]
    return delta.abs().amax(dim=1)


def _final_likelihood(prob: _SeqProblem, assgn, dc, ac):
    """Likelihood recomputed from the end state (assgn.rs:346-354), summed
    in float64 and rounded once, so that it does not depend on the order of
    summation (nor on the device)."""
    depth = _depth_of(prob, assgn)
    dep = _depth_lik_terms(prob.bayes, prob.win_gc, prob.win_weight, depth)
    aln = torch.gather(prob.probs[prob.g], 2, assgn[:, :, None])[:, :, 0]
    return dc * dep.double().sum(dim=1).float() \
        + ac * aln.double().sum(dim=1).float()


def _draw_block(n_chains: int) -> int:
    """Steps or iterations whose draws are made at once: about 4 M words."""
    return int(min(max((1 << 22) // max(n_chains, 1), 16), 1024))


def _chain(draws, prob: _SeqProblem, cfg: SolverConfig, random_init: bool):
    """One annealing chain per (genotype, attempt) (reference `_chain`,
    ops/solver.py:205-294): a random or best start, N_PROBES probes for the
    start temperature, `anneal_steps` steps of Metropolis under linear
    cooling, then `polish_steps` steps that accept any move that loses
    nothing.  Returns (lik [C] f32, assgn [C, R] int64, steps [C])."""
    dc, ac = float(cfg.depth_contrib), float(cfg.aln_contrib)
    assgn = _init_assignment(draws, prob, random_init)
    depth = _depth_of(prob, assgn)
    C = assgn.shape[0]
    dev = assgn.device
    max_abs = _max_probe(draws, prob, assgn, depth, dc, ac)
    ln_init = torch.full_like(max_abs, float(np.log(np.float32(cfg.init_prob))))
    start_temp = torch.clamp_min(-max_abs / ln_init, 1e-5)
    temp_step = (start_temp / torch.full_like(
        start_temp, float(max(cfg.anneal_steps, 1))))[:, None]
    n_total = cfg.anneal_steps + cfg.polish_steps
    block = _draw_block(C)
    for s0 in range(0, n_total, block):
        nb = min(block, n_total - s0)
        u_read, u_cand, u_acc, _ = draws.uniforms(
            torch.arange(s0, s0 + nb, device=dev), _DRAW_STEP)
        for ds in range(nb):
            r, old, new, ws, delta = _propose(
                draws, prob, assgn, depth, u_read[:, ds:ds + 1],
                u_cand[:, ds:ds + 1], dc, ac)
            accept = delta >= 0
            s_rem = max(cfg.anneal_steps - (s0 + ds), 0)
            if s_rem:
                # temp >= start_temp / anneal_steps > 1e-30 here, so the
                # reference's (temp > 0) and max(temp, 1e-30) change nothing.
                accept |= u_acc[:, ds:ds + 1] <= torch.exp(
                    delta / (temp_step * float(s_rem)))
            _apply(prob, assgn, depth, r, old, new, ws, accept)
    steps = torch.full((C,), n_total, dtype=torch.int64, device=dev)
    return _final_likelihood(prob, assgn, dc, ac), assgn, steps


def _greedy_chain(draws, prob: _SeqProblem, cfg: SolverConfig,
                  random_init: bool, stop_check: int = STOP_CHECK):
    """The reference greedy per (genotype, attempt) (reference
    `_greedy_chain`, ops/solver.py:297-404; stoch.rs:36-145): every
    iteration samples `greedy_sample` non-trivial reads with replacement,
    scores every candidate of each, and applies the single best move (the
    first maximum of the [S, K] deltas) if it gains more than
    min_diff = max(1e-6·max|probe delta|, 1e-8).  A chain stops after
    `plato_size` iterations without a gain, or at max(100,000,
    100·plato_size) iterations; a stopped chain does not move again.  The
    loop ends when every chain has stopped, which it looks at once every
    `stop_check` iterations (the result does not depend on it).  Returns
    (lik [C] f32, assgn [C, R] int64, iterations [C])."""
    dc, ac = float(cfg.depth_contrib), float(cfg.aln_contrib)
    assgn = _init_assignment(draws, prob, random_init)
    depth = _depth_of(prob, assgn)
    C = assgn.shape[0]
    K = prob.probs.shape[2]
    S = cfg.greedy_sample
    dev = assgn.device
    min_diff = torch.clamp_min(
        1e-6 * _max_probe(draws, prob, assgn, depth, dc, ac), 1e-8)[:, None]
    max_iter = max(100_000, cfg.plato_size * 100)
    words = -(-S // 4)                  # Philox calls an iteration
    block = _draw_block(C * words)
    ks = torch.arange(K, device=dev)
    pf = prob.probs.reshape(-1)
    pairs = prob.wins.view(-1, 2)
    plato = torch.zeros(C, dtype=torch.int64, device=dev)
    it = torch.zeros(C, dtype=torch.int64, device=dev)
    live = torch.ones(C, dtype=torch.bool, device=dev)
    for n in range(max_iter):
        if n % block == 0:
            nb = min(block, max_iter - n)
            u_all = torch.stack(draws.uniforms(
                torch.arange(n * words, (n + nb) * words, device=dev),
                _DRAW_GREEDY), dim=-1).view(C, nb, 4 * words)[:, :, :S]
        rs = _sample_reads(draws, prob, u_all[:, n % block])      # [C, S]
        old = torch.gather(assgn, 1, rs)
        rk = rs * K
        gix = prob.g_rk + rk
        d_aln = pf[gix[:, :, None] + ks] - pf[gix + old][:, :, None]
        cix = prob.c_rk + rk
        w_old = pairs[cix + old][:, :, None]                       # [C, S, 1, 2]
        w_new = pairs[cix[:, :, None] + ks]                        # [C, S, K, 2]
        d_dep = _depth_lik_diff(prob.bayes, prob.win_gc, prob.win_weight,
                                depth, w_old[..., 0], w_old[..., 1],
                                w_new[..., 0], w_new[..., 1])      # [C, S, K]
        flat = (ac * d_aln + dc * d_dep).view(C, S * K)
        best = flat.argmax(dim=1, keepdim=True)
        improved = (torch.gather(flat, 1, best) > min_diff) & live[:, None]
        si, new = best // K, best % K
        r = torch.gather(rs, 1, si)
        ws = torch.cat([torch.gather(w_old[:, :, 0], 1, si[..., None]
                                     .expand(C, 1, 2)),
                        pairs[prob.c_rk + r * K + new]], dim=-1)  # [C, 1, 4]
        _apply(prob, assgn, depth, r, torch.gather(old, 1, si), new, ws,
               improved)
        plato = torch.where(live, torch.where(improved[:, 0], 0, plato + 1),
                            plato)
        it += live
        live = (plato <= cfg.plato_size) & (it < max_iter)
        if n % stop_check == stop_check - 1 and not bool(live.any()):
            break
    return _final_likelihood(prob, assgn, dc, ac), assgn, it


def solve_genotypes(seed: int, genotypes, hap_prob, hap_mid, unmapped_prob,
                    pack_nwin, pack_regstart, pack_len, gc_at, weight_at,
                    bayes, cfg: SolverConfig, n_attempts: int,
                    max_windows: int, random_init: bool = True,
                    first_row: int = 0, device=None):
    """The sequential engine on a batch of genotypes (reference
    `solve_genotypes`, ops/solver.py:437-453): `n_attempts` chains each,
    `_greedy_chain` when cfg.greedy_sample > 0, else `_chain`.

    genotypes: [G, P] haplotype ids; genotype g is row first_row + g of the
    draws, so a chain's walk does not depend on the chunk that holds it.
    The array arguments may be numpy arrays or tensors; they are moved to
    `device` (None = CUDA, raises without one; "cpu" = the CPU).
    Returns (liks [G, A] f32, assignments [G, A, R] int32 in the ORIGINAL
    candidate-slot order) on `device`."""
    G = len(genotypes)
    draws, prob = seq_setup(seed, genotypes, hap_prob, hap_mid, unmapped_prob,
                            pack_nwin, pack_regstart, pack_len, gc_at,
                            weight_at, bayes, cfg, n_attempts, max_windows,
                            first_row, device)
    chain = _greedy_chain if cfg.greedy_sample > 0 else _chain
    lik, assgn, _ = chain(draws, prob, cfg, random_init)
    return (lik.view(G, n_attempts),
            assgn.to(torch.int32).view(G, n_attempts, -1))


def seq_setup(seed: int, genotypes, hap_prob, hap_mid, unmapped_prob,
              pack_nwin, pack_regstart, pack_len, gc_at, weight_at, bayes,
              cfg: SolverConfig, n_attempts: int, max_windows: int,
              first_row: int, device):
    """The arrays moved to `device` (None = CUDA, raises without one), the
    draws of genotype rows first_row.. and the prologue: (draws,
    _SeqProblem) of a call of this engine or of the batched one
    (ops/solver_batched.py)."""
    dev = _kernels.resolve_device(device)

    def put(x, dtype):
        return torch.as_tensor(x).to(device=dev, dtype=dtype)

    genotypes = put(genotypes, torch.int64)
    hap_prob, unmapped_prob, weight_at, bayes = (
        put(x, torch.float32) for x in (hap_prob, unmapped_prob, weight_at,
                                        bayes))
    hap_mid, pack_nwin, pack_regstart, pack_len, gc_at = (
        put(x, torch.int32) for x in (hap_mid, pack_nwin, pack_regstart,
                                      pack_len, gc_at))
    G = genotypes.shape[0]
    draws = _Draws(seed, first_row + torch.arange(G, device=dev), n_attempts)
    return draws, _seq_problem(draws, genotypes, n_attempts, hap_prob,
                               hap_mid, unmapped_prob, pack_nwin,
                               pack_regstart, pack_len, gc_at, weight_at,
                               bayes, cfg, max_windows)


def build_bayes_table(depth_distrs, alt_cn, mul_coef: float,
                      cap: int = DEPTH_CAP) -> np.ndarray:
    """[101, cap] f32: ln posterior P(CN=1 | depth) per GC bin
    (DistrCache, model/distr_cache.rs:58-93 + BayesCalc bayes.rs:26-36)."""
    ks = np.arange(cap)
    out = np.empty((len(depth_distrs), cap), np.float64)
    for gc, d in enumerate(depth_distrs):
        cn1 = d.mul(mul_coef)
        null = cn1.ln_pmf(ks)
        alts = np.stack([cn1.mul(cn).ln_pmf(ks) for cn in alt_cn])
        stack = np.concatenate([null[None], alts], 0)
        m = stack.max(0)
        out[gc] = null - (m + np.log(np.sum(np.exp(stack - m), 0)))
    return out.astype(np.float32)
