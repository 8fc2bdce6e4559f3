"""PyTorch port of model/locs.py vs the JAX package on a small sim panel.

One simulated panel (numpy, seeded) is built with the JAX package's host
layers, carried over with `convert.from_reference`, and recruited by each
package's host engine; `build_all_alignments_panel` of both must then give
the same candidate alignments.  The JAX side runs on the CPU with
`mesh=None`; the port runs its plain PyTorch aligner (`device="cpu"`).
"""
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from locityper_tpu import sim
from locityper_tpu.bg.err_prof import EditDistCache as JEditDistCache
from locityper_tpu.bg.err_prof import EditThresh as JEditThresh
from locityper_tpu.commands.genotype import recruit_reads as j_recruit_reads
from locityper_tpu.model import Params as JParams
from locityper_tpu.model.locs import \
    build_all_alignments_panel as j_build_panel
from locityper_tpu.pipeline import LocusData as JLocusData
from locityper_tpu.seq.contigs import ContigSet as JContigSet
from locityper_tpu.seq.counts import GenomeKmerCounter, off_target_counts
from locityper_tpu.seq.recruit import RecruitParams as JRecruitParams
from locityper_tpu_torch import convert
from locityper_tpu_torch.bg.err_prof import EditDistCache, EditThresh
from locityper_tpu_torch.model import Params
from locityper_tpu_torch.model import locs as TL
from locityper_tpu_torch.model.locs import (build_all_alignments,
                                            build_all_alignments_panel)
from locityper_tpu_torch.ops import align as TA
from locityper_tpu_torch.pipeline import recruit_reads
from locityper_tpu_torch.seq.recruit import RecruitParams

# One intra-op thread: the suite runs several workers side by side, and the
# tensors here are small.
torch.set_num_threads(1)

sys.path.insert(0, str(Path(__file__).parent))
from test_pipeline import make_bg  # noqa: E402

TRUTH = [(1, 3), (2, 2), (0, 4)]           # one homozygous locus
TABLE_INT_FIELDS = ("mate", "hap", "start", "end", "fwd", "edit", "n_mism",
                    "n_ins", "n_del", "n_clip", "ws")


def make_params(mod_params, bg):
    tech = bg.seq_info.technology
    params = mod_params(unmapped_penalty=tech.default_unmapped_penalty())
    params.set_tweak_size(bg.depth.window_size)
    params.band = 48
    return params


def build_panel(seed=55, n_haps=(5, 6, 5), length=3000, depth=14.0):
    """3 loci × 5-6 haplotypes in a random genome, reads from the true
    genotypes plus off-locus background.  Returns a dict with the JAX
    package's objects ("j_*") and the port's converted copies."""
    rng = np.random.default_rng(seed)
    loci = [sim.simulate_locus(rng, f"G{i}", length=length, n_haps=nh,
                               divergence=0.015)
            for i, nh in enumerate(n_haps)]
    flanks = [sim.random_genome(rng, 20000) for _ in range(len(loci) + 1)]
    parts = [flanks[0]]
    for locus, fl in zip(loci, flanks[1:]):
        parts += [locus.haplotypes[0], fl]
    counter = GenomeKmerCounter(25)
    counter.add_seq(np.concatenate(parts))
    counter.finalize()
    j_data = {}
    for locus in loci:
        kc = off_target_counts(counter, locus.haplotypes, locus.haplotypes[0])
        j_data[locus.name] = JLocusData(
            JContigSet(locus.name, locus.hap_names, locus.haplotypes), kc)
    err = sim.ErrorModel(0.002, 0.0002, 0.0002)
    r1, r2, names = [], [], []
    for locus, gt in zip(loci, TRUTH):
        rd = sim.simulate_paired_reads(
            rng, [locus.haplotypes[h] for h in gt], depth=depth, errors=err,
            prefix=locus.name)
        r1 += rd.reads1
        r2 += rd.reads2
        names += rd.names
    bgr = sim.simulate_paired_reads(rng, flanks[:1], depth=2.0, errors=err,
                                    prefix="bg")
    r1 += bgr.reads1
    r2 += bgr.reads2
    names += bgr.names
    j_bg = make_bg(depth_per_hap=depth)
    data = {k: convert.from_reference(v) for k, v in j_data.items()}
    return dict(loci=loci, j_data=j_data, data=data, reads=(names, r1, r2),
                j_bg=j_bg, bg=convert.from_reference(j_bg))


def recruit_both(p):
    names, r1, r2 = p["reads"]
    j_rec, _ = j_recruit_reads(p["j_data"], zip(names, r1, r2),
                               JRecruitParams(match_frac=0.5),
                               use_device=False)
    rec = recruit_reads(p["data"], zip(names, r1, r2),
                        RecruitParams(match_frac=0.5))
    return j_rec, rec


@pytest.fixture(scope="module")
def panel():
    p = build_panel()
    p["j_rec"], p["rec"] = recruit_both(p)
    return p


def test_state_carried_over_equal(panel):
    for name, jd in panel["j_data"].items():
        d = panel["data"][name]
        assert d.contig_set.contigs.names == jd.contig_set.contigs.names
        for a, b in zip(d.contig_set.seqs, jd.contig_set.seqs):
            np.testing.assert_array_equal(a, b)
        assert d.kmer_counts.k == jd.kmer_counts.k
        for a, b in zip(d.kmer_counts.counts, jd.kmer_counts.counts):
            np.testing.assert_array_equal(a, b)
    assert panel["bg"].to_json() == panel["j_bg"].to_json()
    np.testing.assert_array_equal(panel["bg"].err_prof.score_vec(),
                                  panel["j_bg"].err_prof.score_vec())
    with pytest.raises(TypeError):
        convert.from_reference(object())


def test_state_files_load_in_both_packages(panel, tmp_path):
    """The on-disk forms are shared: each package reads the other's."""
    from locityper_tpu.bg import BgDistr as JBgDistr
    from locityper_tpu_torch.bg import BgDistr
    panel["j_bg"].save(tmp_path / "j.json.gz")
    panel["bg"].save(tmp_path / "t.json.gz")
    assert BgDistr.load(tmp_path / "j.json.gz").to_json() == \
        JBgDistr.load(tmp_path / "t.json.gz").to_json() == \
        panel["j_bg"].to_json()
    # So are a locus's k-mer counts (npz).
    from locityper_tpu.seq.counts import KmerCounts as JKmerCounts
    from locityper_tpu_torch.seq.counts import KmerCounts
    name = next(iter(panel["j_data"]))
    panel["j_data"][name].kmer_counts.save_npz(tmp_path / "j.npz")
    panel["data"][name].kmer_counts.save_npz(tmp_path / "t.npz")
    a, b = (KmerCounts.load_npz(tmp_path / "j.npz"),
            JKmerCounts.load_npz(tmp_path / "t.npz"))
    assert a.k == b.k == 25
    for x, y in zip(a.counts, b.counts):
        np.testing.assert_array_equal(x, y)


def test_host_recruitment_equal(panel):
    for name in panel["j_data"]:
        j_pairs, j_names = panel["j_rec"][name]
        pairs, names = panel["rec"][name]
        assert names == j_names and len(names) > 200
        assert not any(n.startswith("bg") for n in names)
        for (a1, a2), (b1, b2) in zip(pairs[:50], j_pairs[:50]):
            np.testing.assert_array_equal(a1, b1)
            np.testing.assert_array_equal(a2, b2)


def test_build_all_alignments_panel_equal(panel):
    """Integer columns equal, `prob` within 2e-3 (float32 alignment scores
    of magnitude ~1e2; the JAX CPU path is its XLA scan kernel), same
    n_used, same stats, same candidate table."""
    j_bg, bg = panel["j_bg"], panel["bg"]
    j_params, params = make_params(JParams, j_bg), make_params(Params, bg)
    tech = bg.seq_info.technology
    j_cache = JEditDistCache(j_bg.err_prof,
                             JEditThresh.default_for(j_bg.seq_info.technology))
    cache = EditDistCache(bg.err_prof, EditThresh.default_for(tech))
    order = list(panel["j_data"])
    j_in = [(panel["j_rec"][n][0], panel["j_rec"][n][1],
             panel["j_data"][n].contig_set, panel["j_data"][n].kmer_counts)
            for n in order]
    t_in = [(panel["rec"][n][0], panel["rec"][n][1],
             panel["data"][n].contig_set, panel["data"][n].kmer_counts)
            for n in order]
    want = j_build_panel(j_in, j_bg, j_cache, j_params, mesh=None)
    got = build_all_alignments_panel(t_in, bg, cache, params, device="cpu")
    panel["built"] = got
    for (j_alns, j_stats), (alns, stats), name in zip(want, got, order):
        assert stats == j_stats, name
        assert alns.n_used == j_alns.n_used > 200
        t1, t2 = j_alns.table, alns.table
        assert len(t1) == len(t2)
        for f in TABLE_INT_FIELDS:
            np.testing.assert_array_equal(getattr(t2, f), getattr(t1, f),
                                          err_msg=f"{name} {f}")
        np.testing.assert_allclose(t2.prob, t1.prob, rtol=0, atol=2e-3)
        for f in ("c_read", "c_hap", "c_mid1", "c_mid2", "c_a1", "c_a2",
                  "used_mask", "read_ix"):
            np.testing.assert_array_equal(getattr(alns, f),
                                          getattr(j_alns, f), err_msg=f)
        np.testing.assert_allclose(alns.c_prob, j_alns.c_prob, rtol=0,
                                   atol=2e-3)
        assert alns.names == j_alns.names
        carried = convert.from_reference(j_alns)
        np.testing.assert_array_equal(carried.c_prob, j_alns.c_prob)
        np.testing.assert_array_equal(carried.table.prob, t1.prob)

    # Per-locus build equals the panel build (shared L bucket, groups).
    n = order[0]
    single, s_stats = build_all_alignments(
        panel["rec"][n][0], panel["rec"][n][1], panel["data"][n].contig_set,
        panel["data"][n].kmer_counts, bg, cache, params, device="cpu")
    assert s_stats == got[0][1]
    np.testing.assert_array_equal(single.table.prob, got[0][0].table.prob)
    np.testing.assert_array_equal(single.c_prob, got[0][0].c_prob)


# --- K1's inputs: the job table gathered on the device ----------------------

def host_assembly(mates, jobs, haps, band, L):
    """The host assembly that the job table replaced, kept here as the
    oracle: every job's read picked from a forward and a reverse-complement
    [M, L] matrix, its window cut from its haplotype by `extract_windows`.
    Returns (reads [J, L], lens [J], wins [J, L + band], meta)."""
    jm, jh, jo, jd = (np.asarray(a, np.int64) for a in jobs)
    M = len(mates)
    lens = np.fromiter((m.size for m in mates), np.int64, M)
    fwd = np.full((M, L), 4, np.int8)
    fwd[np.arange(L)[None, :] < lens[:, None]] = np.concatenate(mates)
    comp = np.where(fwd < 4, 3 - fwd, 4).astype(np.int8)
    src = lens[:, None] - 1 - np.arange(L)[None, :]
    rc = np.where(src >= 0,
                  comp[np.arange(M)[:, None], np.clip(src, 0, L - 1)],
                  np.int8(4)).astype(np.int8)
    W = L + band
    all_ws = jd - band // 2
    wins = np.full((jm.size, W), 4, np.int8)
    for hp in np.unique(jh):
        rows = np.nonzero(jh == hp)[0]
        wins[rows] = TA.extract_windows(haps[hp], all_ws[rows], W)
    reads = np.where(jo[:, None] == 1, rc[jm], fwd[jm])
    return reads, lens[jm].astype(np.int32), wins, (jm, jh, jo, all_ws)


def gather_locus(rng, n_haps, hap_len, n_mates, n_jobs, read_len, diag,
                 strand=None):
    """Haplotypes of about `hap_len`, mates cut from them (either strand,
    a few N codes, lengths read_len // 4 to read_len) and jobs with their
    diagonal drawn from `diag`, a (low, high) pair of functions of the
    haplotype's length."""
    haps = [rng.integers(0, 4, hap_len + rng.integers(-40, 41))
            .astype(np.int8) for _ in range(n_haps)]
    mates = []
    for _ in range(n_mates):
        h = haps[rng.integers(n_haps)]
        n = int(rng.integers(read_len // 4, read_len + 1))
        s = int(rng.integers(0, h.size - n))
        m = h[s:s + n].copy()
        if rng.random() < 0.5:
            m = (3 - m[::-1]).astype(np.int8)
        m[rng.random(n) < 0.01] = 4
        mates.append(m)
    jh = rng.integers(0, n_haps, n_jobs)
    lo, hi = diag
    jd = np.array([rng.integers(lo(haps[h].size), hi(haps[h].size))
                   for h in jh], np.int64)
    jo = (rng.integers(0, 2, n_jobs) if strand is None
          else np.full(n_jobs, strand))
    return mates, (rng.integers(0, n_mates, n_jobs), jh, jo, jd), haps


ANY = (lambda n: -60, lambda n: n + 60)
#: name: (loci as gather_locus's keywords, read length, panel L, band,
#: batch)
GATHER_CASES = {
    "ws-below-zero": ([dict(n_haps=3, hap_len=600, n_mates=30, n_jobs=120,
                            diag=(lambda n: -400, lambda n: 20))],
                      100, None, 32, None),
    "window-past-the-end": ([dict(n_haps=3, hap_len=600, n_mates=30,
                                  n_jobs=120, diag=(lambda n: n - 150,
                                                    lambda n: n + 400))],
                            100, None, 32, None),
    "reverse-short-reads": ([dict(n_haps=2, hap_len=500, n_mates=40,
                                  n_jobs=100, diag=ANY, strand=1)],
                            60, None, 16, None),
    "panel-L-above-bucket": ([dict(n_haps=2, hap_len=500, n_mates=25,
                                   n_jobs=80, diag=ANY)],
                             60, 192, 16, None),
    "three-loci-one-empty": ([dict(n_haps=2, hap_len=300, n_mates=20,
                                   n_jobs=60, diag=ANY),
                              dict(n_haps=5, hap_len=900, n_mates=30,
                                   n_jobs=0, diag=ANY),
                              dict(n_haps=4, hap_len=500, n_mates=25,
                                   n_jobs=90, diag=ANY)],
                             100, 128, 32, None),
    "batch-inside-a-locus": ([dict(n_haps=3, hap_len=400, n_mates=20,
                                   n_jobs=70, diag=ANY),
                              dict(n_haps=2, hap_len=700, n_mates=30,
                                   n_jobs=90, diag=ANY)],
                             100, 128, 32, 37),
}


@pytest.mark.parametrize("case", list(GATHER_CASES))
def test_gathered_k1_inputs_equal_the_host_assembly(case, monkeypatch):
    """A group's job tables, joined, staged and gathered batch by batch,
    hand `ops/align.align_banded` (looked up by attribute) the host
    assembly's reads, lengths and windows byte for byte, in job order;
    `_finish_align` then gives the host assembly's table field for field."""
    specs, read_len, panel_L, band, batch = GATHER_CASES[case]
    rng = np.random.default_rng(sorted(GATHER_CASES).index(case))
    loci = [gather_locus(rng, read_len=read_len, **s) for s in specs]
    L = panel_L or -(-read_len // 64) * 64
    sv = np.array(TA.Scores.from_error_rates(0.002, 0.0002, 0.0002)
                  .astuple(), np.float32)
    tables, metas = zip(*(TL._prepare_align_jobs(
        mates, jobs, SimpleNamespace(seqs=haps), band, L=panel_L)
        for mates, jobs, haps in loci))
    want = [host_assembly(mates, jobs, haps, band, L)
            for mates, jobs, haps in loci]
    seen = []
    align = TA.align_banded

    def recording(reads, rlens, hap_wins, score_vec, band, *a):
        seen.append((reads, rlens, hap_wins))
        return align(reads, rlens, hap_wins, score_vec, band, *a)

    monkeypatch.setattr(TA, "align_banded", recording)
    joined = TL.AlignJobs.join(tables)
    res = TL.run_align_batches(joined, sv, band, batch=batch, device="cpu")
    n_jobs = sum(s["n_jobs"] for s in specs)
    assert len(joined) == n_jobs
    assert len(seen) == -(-n_jobs // (batch or n_jobs))
    for i, name in enumerate(("reads", "lens", "wins")):
        got = torch.cat([s[i] for s in seen]).numpy()
        exp = np.concatenate([w[i] for w in want])
        assert got.dtype == exp.dtype and got.shape == exp.shape, name
        assert got.tobytes() == exp.tobytes(), name
    assert seen[0][0].shape[1] == L and seen[0][2].shape[1] == L + band
    if "ws-below" in case:
        assert (np.concatenate([m[3] for m in metas]) < -(L + band)).any()
    if "past-the-end" in case:
        assert any((m[3] > np.array([loci[0][2][h].size for h in m[1]]))
                   .any() for m in metas)

    off = 0
    for table, meta, (reads, lens, wins, w_meta) in zip(tables, metas, want):
        n = len(table)
        got = TL._finish_align({k: v[off:off + n] for k, v in res.items()},
                               meta, table.job_lens())
        ref = {k: v.numpy() for k, v in TA.align_batch_reference(
            *(torch.from_numpy(x) for x in (reads, lens, wins, sv)),
            band).items()}
        exp = TL._finish_align(ref, w_meta, lens)
        for f in TL.MateAlnTable._FIELDS:
            np.testing.assert_array_equal(getattr(got, f), getattr(exp, f),
                                          err_msg=f)
        off += n
