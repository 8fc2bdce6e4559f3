"""The plain reference against the port's own host engine and plain
kernels, at a small size on the CPU (the tests may import the port; the
reference may not)."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_port import gen, reference

ROOT = Path(gen.__file__).resolve().parent
CFG = json.loads((ROOT / "configs" / "hla_abc_sr.json").read_text())
CFG["panel"].update(n_loci=4, n_clades=3, haps_per_clade=2)
CFG["flank_len"] = 8000
TRAFFIC = json.loads((ROOT / "traffic" / "locus_reads.json").read_text())


def test_recruitment_equals_the_host_engine_on_padded_reads():
    from locityper_tpu_torch.seq.contigs import ContigSet
    from locityper_tpu_torch.seq.counts import (GenomeKmerCounter,
                                                off_target_counts)
    from locityper_tpu_torch.seq.recruit import (RecruitParams, TargetIndex,
                                                 recruit_read_pair)
    seed = 2**35 + 3
    loci, genome, flanks, starts = gen.build_panel(CFG, seed)
    s = gen.draw_sample(loci, CFG, TRAFFIC, seed, 0)
    f1, f2 = gen.flank_pairs(flanks, CFG, TRAFFIC, seed)
    fn = gen.flank_names(f1.shape[0])
    index = reference.RecruitIndex(loci, genome, starts, "cpu")
    got = reference.recruit(index, s.names, s.mates1, s.mates2,
                            (fn, f1, f2))
    counter = GenomeKmerCounter(25)
    counter.add_seq(genome)
    counter.finalize()
    host = TargetIndex(RecruitParams())
    for lc, st in zip(loci, starts):
        host.add_locus(ContigSet(lc.name, lc.hap_names, lc.haplotypes),
                       off_target_counts(counter, lc.haplotypes,
                                         genome[st:st + lc.haplotypes[0].size]))
    host.finalize()
    assert host.keys.size == index.keys.numel()
    pad = np.full(9, 4, np.int8)      # the card's rows end in N
    want = {lc.name: set() for lc in loci}
    pairs = list(zip(s.names, s.mates1, s.mates2)) + \
        [(fn[i], f1[i], f2[i]) for i in range(0, f1.shape[0], 3)]
    for name, a, b in pairs:
        for li in recruit_read_pair(host, np.concatenate([a, pad]),
                                    np.concatenate([b, pad])):
            want[loci[li].name].add(name)
    kept = {n for n, *_ in pairs}
    assert {k: v & kept for k, v in got.items()} == want
    assert sum(map(len, want.values())) > 0.9 * len(s.names)
    # Shorter keys, as the control's, merge keys and recruit more.
    assert reference.RecruitIndex(loci, genome, starts, "cpu", bits=16) \
        .keys.numel() < index.keys.numel()
    low = reference.RecruitIndex(loci, genome, starts, "cpu", bits=10)
    got10 = reference.recruit(low, s.names, s.mates1, s.mates2,
                              (fn, f1, f2))
    assert sum(map(len, got10.values())) > sum(map(len, got.values()))


def test_aligner_equals_the_ports_plain_version():
    from locityper_tpu_torch.ops.align import align_batch_reference
    g = torch.Generator().manual_seed(3)
    N, L, band = 64, 40, 12
    hap = torch.randint(0, 4, (4000,), generator=g, dtype=torch.int8)
    start = torch.randint(band, 3000, (N,), generator=g)
    reads = hap[start[:, None] + torch.arange(L)]
    flip = torch.rand((N, L), generator=g) < 0.03
    reads = torch.where(flip, (reads + 1) % 4, reads).to(torch.int8)
    lens = torch.randint(L // 2, L + 1, (N,), generator=g, dtype=torch.int32)
    wins = hap[(start - band // 2)[:, None] + torch.arange(L + band)]
    sv = torch.tensor([-0.0024, -6.2, -8.5, -8.5, -6.2])
    want = align_batch_reference(reads, lens, wins, sv, band)
    got = reference.align(reads, lens, wins, sv, band)
    for k, v in got.items():
        assert torch.equal(want[k].to(v.dtype), v), k
    low = reference.align(reads, lens, wins, sv, band, dtype=torch.bfloat16)
    assert not torch.equal(low["score"], got["score"])


def test_chain_likelihood_equals_the_annealers():
    from locityper_tpu_torch.ops.solver_chains import anneal_chains_reference
    g = torch.Generator().manual_seed(5)
    G, A, R, K, W, D = 2, 3, 30, 3, 9, 6
    C = G * A
    probs = -torch.rand((G, R, K), generator=g) * 5
    vcount = torch.full((G, R), K, dtype=torch.int32)
    nt_ixs = torch.arange(R, dtype=torch.int32).repeat(G, 1)
    ntc = torch.full((G,), R, dtype=torch.int32)
    w1 = torch.randint(0, W, (C, R, K), generator=g)
    w2 = torch.randint(0, W, (C, R, K), generator=g)
    winpk = (w1 | (w2 << 16)).to(torch.int32)
    wtab = -torch.rand((C, W, D), generator=g) * 3
    assgn0 = torch.randint(0, K, (C, R), generator=g, dtype=torch.int32)
    wp0 = torch.gather(winpk, 2, assgn0.long()[:, :, None])[:, :, 0].long()
    depth0 = torch.zeros((C, W), dtype=torch.int32)
    depth0.scatter_add_(1, wp0 & 0xFFFF, torch.ones_like(wp0, dtype=torch.int32))
    depth0.scatter_add_(1, wp0 >> 16, torch.ones_like(wp0, dtype=torch.int32))
    cache0 = torch.gather(wtab, 2, depth0.clamp(max=D - 1).long()[:, :, None])[:, :, 0]
    lik, assgn, _ = anneal_chains_reference(
        probs, winpk, vcount, nt_ixs, ntc, torch.ones(G), wtab, assgn0,
        depth0, cache0, attempts=A, n_steps=300, anneal_steps=200, dc=0.7,
        ac=1.3, seed=9)
    cix = torch.arange(C) // A
    ref = reference.chain_likelihood(probs[cix], winpk, wtab, assgn, 0.7,
                                     1.3)
    assert torch.allclose(lik.double(), ref, rtol=1e-6)
    assert not torch.equal(assgn, assgn0)


def test_haplotype_stretches():
    from bench_port.check import haplotype_bytes
    loci, *_ = gen.build_panel(CFG, 7)
    panel = haplotype_bytes(loci)

    def has(seq):
        return seq.astype(np.int8).tobytes() in panel
    h = loci[1].haplotypes[2]
    assert has(h[100:340]) and has(h[:10]) and has(h)
    bad = h[100:340].copy()
    bad[50] = (bad[50] + 1) % 4
    assert not has(bad)
    across = np.concatenate([loci[0].haplotypes[-1][-30:],
                             loci[1].haplotypes[0][:30]])
    assert not has(across)


def _random_chains(C=3, R=12, K=4, W=6, D=5, seed=4):
    g = torch.Generator().manual_seed(seed)
    probs = -torch.rand((C, R, K), generator=g) * 4
    probs[:, ::3, 2:] = reference.NEG          # reads of two candidates
    probs[:, 1, 1:] = reference.NEG            # a read of one
    w1 = torch.randint(0, W, (C, R, K), generator=g)
    w2 = torch.randint(0, W, (C, R, K), generator=g)
    winpk = (w1 | (w2 << 16)).to(torch.int32)
    wtab = -torch.rand((C, W, D), generator=g) * 3
    assgn = torch.zeros((C, R), dtype=torch.int32)
    return probs, winpk, wtab, assgn


def test_best_move_gain_equals_rescoring_every_move():
    probs, winpk, wtab, assgn = _random_chains()
    C, R, K = probs.shape
    got = reference.best_move_gain(probs, winpk, wtab, assgn, 0.7, 1.3)
    base = reference.chain_likelihood(probs, winpk, wtab, assgn, 0.7, 1.3)
    for c in range(C):
        best = -float("inf")
        for r in range(R):
            for k in range(K):
                if k == assgn[c, r] or probs[c, r, k] <= reference.NEG / 2:
                    continue
                a = assgn[c:c + 1].clone()
                a[0, r] = k
                lik = reference.chain_likelihood(
                    probs[c:c + 1], winpk[c:c + 1], wtab[c:c + 1], a, 0.7,
                    1.3)
                best = max(best, float(lik[0] - base[c]))
        assert float(got[c]) == pytest.approx(best, abs=1e-9)
    lone = probs.clone()
    lone[:, :, 1:] = reference.NEG
    assert torch.isinf(reference.best_move_gain(lone, winpk, wtab, assgn,
                                                0.7, 1.3)).all()


def _chain(assgn, anneals, probs, winpk, wtab):
    return dict(probs=probs, winpk=winpk, wtab=wtab, assgn=assgn,
                anneals=anneals, dc=0.0, ac=1.0,
                lik=reference.chain_likelihood(probs, winpk, wtab, assgn,
                                               0.0, 1.0).float())


def test_unpolished_share():
    from bench_port.check import chain_numbers
    probs, winpk, wtab, _ = _random_chains()
    # Without the depth term every read's best candidate is the optimum.
    top = probs.argmax(2).to(torch.int32)
    worst = torch.where(probs > reference.NEG / 2, probs, 1.0).argmin(2) \
        .to(torch.int32)
    gap, share = chain_numbers([_chain(top, True, probs, winpk, wtab)])
    assert gap < 1e-6 and share == 0.0
    assert chain_numbers([_chain(worst, True, probs, winpk, wtab)])[1] == 1.0
    # Polish-only launches do not count; no chain with a move: 1.
    assert chain_numbers([_chain(top, True, probs, winpk, wtab),
                          _chain(worst, False, probs, winpk, wtab)])[1] == 0.0
    assert chain_numbers([_chain(top, False, probs, winpk, wtab)])[1] == 1.0


def test_probe_picks_are_seeded_distinct_and_sorted():
    from bench_port.check import Probe
    a, b = Probe(2**40 + 1), Probe(2**40 + 1)
    cpu = torch.device("cpu")
    x, y = a._pick(1000, 16, cpu), b._pick(1000, 16, cpu)
    assert torch.equal(x, y) and x.numel() == 16
    assert torch.equal(x, torch.unique(x))
    assert not torch.equal(a._pick(1000, 16, cpu), x)
    assert torch.equal(a._pick(5, 16, cpu), torch.arange(5))
    assert not torch.equal(Probe(3)._pick(1000, 16, cpu), x)
