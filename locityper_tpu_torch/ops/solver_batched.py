"""Batched-move annealing (`e=batched`): synchronous proposals for every read.

Counterpart of the reference package's ops/solver_batched.py, which is plain
XLA there (no Pallas kernel); plain PyTorch here, on either device.  The
sequential chain (ops/solver.py, mirroring stoch.rs) moves ONE read a step.
This engine moves all of them at once:

  per super-step, for every chain (genotype × attempt):
    1. every read draws a random other valid candidate;
    2. each read's delta is computed against the CURRENT depth vector
       (the shared-window cascade of assgn.rs:259-284, read by read);
    3. each read accepts independently (Metropolis at the current
       temperature, linear cooling over `anneal_steps_b` super-steps, then
       improvements only), and an accepted move is kept with probability
       `move_thin`, to limit the interaction of simultaneous moves;
    4. all kept moves apply at once (four scatter-adds into the depth);
       the likelihood is recomputed exactly from the end state.

A blocked proposal is a different Markov kernel than stoch.rs's, with the
same target (maximum likelihood); tests/test_torch_batched.py holds it to
the exact ILP optimum.

The prologue is the sequential engine's (`ops/solver.py:seq_setup`).  Its
random numbers come from the same counter-based Philox4x32-10, keyed by the
stage seed and counted by (genotype row, attempt, read, super-step): super-
step s draws with kind `_DRAW_BATCHED + s`, word 0 for the proposal, word 1
for the acceptance, word 2 for the thinning coin.  So a chain's walk depends
neither on the other chains of its call nor on the device's generator.
"""
from __future__ import annotations

import math

import torch

from .solver import (NEG, SolverConfig, _depth_lik_diff, _depth_of,
                     _final_likelihood, _init_assignment, seq_setup)

#: First kind of draw of the super-steps; the kinds below it are the
#: sequential engine's (ops/solver.py).
_DRAW_BATCHED = 6


def _start_temp(prob, cfg: SolverConfig):
    """[G] initial temperatures from the spread of each read's valid
    candidate probabilities (counterpart of stoch.rs:19-29's probe of
    max |delta|): (max over reads of the spread) · aln_contrib + 10, over
    -ln(init_prob), at least 1e-5."""
    probs = prob.probs
    live = probs > NEG / 2
    spread = torch.where(live, probs, -math.inf).amax(dim=2) \
        - torch.where(live, probs, math.inf).amin(dim=2)
    spread = torch.where(torch.isfinite(spread), spread, -math.inf)
    mx = spread.amax(dim=1)
    mx = torch.where(torch.isfinite(mx), mx, 1.0)
    max_abs = mx * cfg.aln_contrib + 10.0
    ln_init = torch.log(torch.tensor(cfg.init_prob, dtype=torch.float32,
                                     device=probs.device))
    return torch.clamp_min(-max_abs / ln_init, 1e-5)


def _steps_a_block(n_draws: int) -> int:
    """Super-steps whose draws are made at once: about 4 M words."""
    return int(min(max((1 << 22) // max(n_draws, 1), 1), 64))


def _batched_chain(draws, prob, cfg: SolverConfig, random_init: bool,
                   n_steps: int):
    """`n_steps` super-steps of every chain of the call.  Returns
    (lik [C] f32, assgn [C, R] int64 in the original candidate slots)."""
    dc, ac = float(cfg.depth_contrib), float(cfg.aln_contrib)
    assgn = _init_assignment(draws, prob, random_init)
    depth = _depth_of(prob, assgn)
    C, R = assgn.shape
    K = prob.probs.shape[2]
    dev = assgn.device
    vc = prob.vcount[prob.g]                            # [C, R]
    nontrivial = vc > 1
    n_other = torch.clamp_min(vc, 2) - 1
    start_temp = _start_temp(prob, cfg)[prob.g][:, None]
    denom = torch.full_like(start_temp, float(max(cfg.anneal_steps_b, 1)))
    rk = torch.arange(R, device=dev) * K
    gix = prob.g_rk + rk                                # (g·R + r)·K
    cix = prob.c_rk + rk                                # (c·R + r)·K
    pf = prob.probs.reshape(-1)
    vo = prob.vorder.reshape(-1)
    vp = prob.vpos.reshape(-1)
    pairs = prob.wins.view(-1, 2)
    reads = torch.arange(R, device=dev)
    thin = torch.tensor(cfg.move_thin, dtype=torch.float32, device=dev)
    block = _steps_a_block(C * R)
    for s0 in range(0, n_steps, block):
        nb = min(block, n_steps - s0)
        kinds = (_DRAW_BATCHED + s0
                 + torch.arange(nb, device=dev)).repeat_interleave(R)
        u_prop, u_acc, u_thin, _ = (
            u.view(C, nb, R) for u in draws.uniforms(reads.repeat(nb),
                                                     kinds))
        for ds in range(nb):
            s = s0 + ds
            # A random OTHER valid candidate of every read
            # (ReassignmentTarget::random, vectorised over reads).
            old_pos = vp[gix + assgn]
            i = 1 + draws.randint(u_prop[:, ds], n_other)
            new = vo[gix + torch.where(i <= old_pos, i - 1, i)]
            new = torch.where(nontrivial, new, assgn)
            w_old = pairs[cix + assgn]                  # [C, R, 2]
            w_new = pairs[cix + new]
            d_dep = _depth_lik_diff(prob.bayes, prob.win_gc, prob.win_weight,
                                    depth, w_old[..., 0], w_old[..., 1],
                                    w_new[..., 0], w_new[..., 1])
            delta = ac * (pf[gix + new] - pf[gix + assgn]) + dc * d_dep
            accept = delta >= 0
            s_rem = max(cfg.anneal_steps_b - s, 0)
            if s_rem:
                # temp >= start_temp / anneal_steps_b > 1e-30 here, so the
                # reference's (temp > 0) and max(temp, 1e-30) change
                # nothing.
                temp = start_temp * float(s_rem) / denom
                accept |= u_acc[:, ds] <= torch.exp(delta / temp)
            accept &= nontrivial & (u_thin[:, ds] < thin)
            assgn = torch.where(accept, new, assgn)
            inc = accept.long()[..., None].expand(C, R, 2).reshape(C, 2 * R)
            depth.scatter_add_(1, w_new.reshape(C, 2 * R), inc)
            depth.scatter_add_(1, w_old.reshape(C, 2 * R), -inc)
    return _final_likelihood(prob, assgn, dc, ac), assgn


def solve_genotypes(seed: int, genotypes, hap_prob, hap_mid, unmapped_prob,
                    pack_nwin, pack_regstart, pack_len, gc_at, weight_at,
                    bayes, cfg: SolverConfig, n_attempts: int,
                    max_windows: int, n_steps: int = 1000,
                    random_init: bool = True, first_row: int = 0,
                    device=None):
    """The batched-move engine on a batch of genotypes (reference
    `solve_genotypes_batched`): `n_attempts` chains each, `n_steps`
    super-steps, cooling over cfg.anneal_steps_b of them.

    genotypes: [G, P] haplotype ids; genotype g is row first_row + g of the
    draws.  The array arguments may be numpy arrays or tensors; they are
    moved to `device` (None = CUDA, raises without one; "cpu" = the CPU).
    Returns (liks [G, A] f32, assignments [G, A, R] int32 in the ORIGINAL
    candidate-slot order) on `device`."""
    G = len(genotypes)
    draws, prob = seq_setup(seed, genotypes, hap_prob, hap_mid, unmapped_prob,
                            pack_nwin, pack_regstart, pack_len, gc_at,
                            weight_at, bayes, cfg, n_attempts, max_windows,
                            first_row, device)
    lik, assgn = _batched_chain(draws, prob, cfg, random_init, n_steps)
    return (lik.view(G, n_attempts),
            assgn.to(torch.int32).view(G, n_attempts, -1))
