"""The first slice of the port as a whole, against the JAX package.

Sim panel of 3 loci × 5-6 haplotypes (one homozygous truth), reads recruited
by the host engine, then alignment and solving: the port on `device="cpu"`
(plain PyTorch aligner and annealer), the JAX package on the CPU with
`mesh=None` (its `auto` engine is the sequential XLA chain there).  The two
annealers draw different random numbers, so calls are compared, and
likelihoods within a tolerance.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from locityper_tpu.bg.err_prof import EditDistCache as JEditDistCache
from locityper_tpu.bg.err_prof import EditThresh as JEditThresh
from locityper_tpu.model import Params as JParams
from locityper_tpu.model.locs import \
    build_all_alignments_panel as j_build_panel
from locityper_tpu.pipeline import genotype_panel as j_genotype_panel
from locityper_tpu.solvers.solve import Scheme as JScheme
from locityper_tpu_torch.bg.err_prof import EditDistCache, EditThresh
from locityper_tpu_torch.model import Params
from locityper_tpu_torch.model.locs import build_all_alignments_panel
from locityper_tpu_torch.pipeline import (_prepare_solve_inputs,
                                          genotype_locus, genotype_panel)
from locityper_tpu_torch.solvers.solve import (PanelItem, Scheme, Stage,
                                               solve_locus, solve_panel)

# One intra-op thread: the suite runs several workers side by side, and the
# tensors here are small.
torch.set_num_threads(1)

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_locs import (TRUTH, build_panel, make_params,  # noqa: E402
                             recruit_both)

LIGHT = ["greedy:i=5k,a=1", "anneal:i=8,a=8,n=3000,p=2000"]


@pytest.fixture(scope="module")
def solved():
    """Runs both packages once over the panel."""
    p = build_panel()
    j_rec, rec = recruit_both(p)
    order = list(p["j_data"])
    j_bg, bg = p["j_bg"], p["bg"]
    j_params, params = make_params(JParams, j_bg), make_params(Params, bg)
    j_cache = JEditDistCache(j_bg.err_prof,
                             JEditThresh.default_for(j_bg.seq_info.technology))
    cache = EditDistCache(bg.err_prof,
                          EditThresh.default_for(bg.seq_info.technology))
    j_built = j_build_panel(
        [(j_rec[n][0], j_rec[n][1], p["j_data"][n].contig_set,
          p["j_data"][n].kmer_counts) for n in order],
        j_bg, j_cache, j_params, mesh=None)
    built = build_all_alignments_panel(
        [(rec[n][0], rec[n][1], p["data"][n].contig_set,
          p["data"][n].kmer_counts) for n in order],
        bg, cache, params, device="cpu")
    j_entries = [dict(locus=p["j_data"][n], read_pairs=j_rec[n][0],
                      names=j_rec[n][1], tag=n, prebuilt=j_built[i])
                 for i, n in enumerate(order)]
    entries = [dict(locus=p["data"][n], read_pairs=rec[n][0],
                    names=rec[n][1], tag=n, prebuilt=built[i])
               for i, n in enumerate(order)]
    j_out = j_genotype_panel(j_entries, j_bg, params=j_params,
                             scheme=JScheme.parse(LIGHT), seed=3, mesh=None)
    out = genotype_panel(entries, bg, params=params,
                         scheme=Scheme.parse(LIGHT), seed=3, device="cpu")
    return dict(p=p, order=order, entries=entries, bg=bg, params=params,
                j_out=j_out, out=out)


def test_calls_equal_truth_and_reference(solved):
    for (res, _), (j_res, _), truth in zip(solved["out"], solved["j_out"],
                                           TRUTH):
        call = tuple(sorted(int(h) for h in res.genotypes[0]))
        j_call = tuple(sorted(int(h) for h in j_res.genotypes[0]))
        assert call == truth, (res.tag, call, truth)
        assert call == j_call
        assert res.total_reads == j_res.total_reads
        assert res.unexpl_reads == j_res.unexpl_reads
        assert res.warnings == j_res.warnings


def lik_spread(pa, pb):
    """The repo's own bound for two runs of one objective with different
    random streams (tests/test_panel.py): each attempt re-randomizes the
    window tweaks, so means agree within the attempt-to-attempt spread."""
    return 4.0 * np.sqrt(pa.lik_var / pa.attempts
                         + pb.lik_var / pb.attempts) + 1.0


def test_top_likelihood_close_to_reference(solved):
    """Mean ln-likelihood (magnitude ~480) of the called genotype: within
    the spread of its 8 stochastic attempts.  A fixed 0.5 ln units does not
    hold even between two seeds of one package — the port's own per-locus
    and panel runs differ by up to 1.2."""
    for (res, _), (j_res, _) in zip(solved["out"], solved["j_out"]):
        pa, pb = res.predictions[0], j_res.predictions[0]
        print(f"{res.tag}: lik_mean port {pa.lik_mean:.3f}, reference "
              f"{pb.lik_mean:.3f}, gap {abs(pa.lik_mean - pb.lik_mean):.3f}, "
              f"limit {lik_spread(pa, pb):.3f}")
        assert pa.lik_mean == pytest.approx(pb.lik_mean,
                                            abs=lik_spread(pa, pb))
        assert res.quality > 20 and j_res.quality > 20


def test_result_json_schema_equal(solved):
    p = solved["p"]
    for (res, _), (j_res, _), name in zip(solved["out"], solved["j_out"],
                                          solved["order"]):
        hap_names = p["data"][name].contig_set.contigs.names
        obj, j_obj = res.to_json(hap_names), j_res.to_json(hap_names)
        assert set(obj) == set(j_obj)
        assert obj["genotype"] == j_obj["genotype"]
        assert set(obj["options"][0]) == set(j_obj["options"][0])
        assert isinstance(obj["options"][0]["lik_mean"], float)
        assign = res.predictions[0].assignments
        assert assign.shape[0] == 8 and assign.dtype == np.int32


def test_solve_locus_equals_solve_panel(solved):
    """Per-locus and cross-locus solving call the same genotypes with
    likelihoods equal within the attempts' spread (another random stream
    per layout); a one-locus panel is the same program as `solve_locus` and
    gives identical numbers."""
    bg, params = solved["bg"], solved["params"]
    scheme = Scheme.parse(["anneal:i=6,a=4,n=800,p=400"])
    items = []
    for e in solved["entries"]:
        prep = _prepare_solve_inputs(e["locus"], e["prebuilt"][0], bg, params,
                                     2, None, None, 0, None)
        items.append(PanelItem(tensors=prep["tensors"], pack=prep["pack"],
                               genotypes=prep["genotypes"],
                               priors=prep["priors"], tag=e["tag"]))
    paneled = solve_panel(items, bg, params, scheme, 9, device="cpu")
    singles = [solve_locus(it.tensors, it.pack, bg, it.genotypes, it.priors,
                           params, scheme, 9, tag=it.tag, device="cpu")
               for it in items]
    for single, pres, truth in zip(singles, paneled, TRUTH):
        assert tuple(sorted(single.genotypes[0])) == truth
        assert tuple(sorted(pres.genotypes[0])) == truth
        pa, pb = single.predictions[0], pres.predictions[0]
        assert pa.lik_mean == pytest.approx(pb.lik_mean,
                                            abs=lik_spread(pa, pb))
    one = solve_panel(items[:1], bg, params, scheme, 9, device="cpu")[0]
    assert one.genotypes == singles[0].genotypes
    np.testing.assert_array_equal(one.ln_probs, singles[0].ln_probs)


def test_genotype_locus_and_unported_options(solved):
    e = solved["entries"][1]
    bg, params = solved["bg"], solved["params"]
    res, stats = genotype_locus(
        e["locus"], e["read_pairs"], e["names"], bg, params=params,
        scheme=Scheme.parse(["greedy:i=5k,a=1,init=prev"]), seed=4,
        prebuilt_alns=e["prebuilt"], device="cpu")
    assert tuple(sorted(res.genotypes[0])) == TRUTH[1]
    assert stats == e["prebuilt"][1]
    for spec, exc in (("anneal:e=batched", NotImplementedError),
                      ("anneal:e=nope", ValueError)):
        with pytest.raises(exc):
            genotype_locus(e["locus"], e["read_pairs"], e["names"], bg,
                           params=params, scheme=Scheme.parse([spec]),
                           prebuilt_alns=e["prebuilt"], device="cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        solve_panel([], bg, params, Scheme([Stage(kind="anneal")]), 1,
                    mesh=object(), device="cpu")


def test_scheme_parsing_equal():
    for specs in ([], LIGHT, ["greedy:i=1k,a=2,s=5,p=50",
                              "anneal:i=20,a=20,init=prev,e=chains"]):
        a, b = Scheme.parse(specs), JScheme.parse(specs)
        assert len(a.stages) == len(b.stages)
        for sa, sb in zip(a.stages, b.stages):
            for f in ("kind", "in_size", "attempts", "anneal_steps",
                      "polish_steps", "sample", "plato", "seed_prev"):
                assert getattr(sa, f) == getattr(sb, f), f
