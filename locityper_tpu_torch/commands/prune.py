"""`prune` command: thin the haplotype panel by hierarchical clustering.

Counterpart of reference command/prune.rs: complete-linkage clustering of
haplotypes by divergence (:367-433, kodama → scipy here), cut at a fixed
threshold or to a target cluster count, representative = haplotype with the
smallest power-mean intra-cluster divergence (:249-341), then thin the DB
files (:475-521).  Newick tree output preserved.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
from scipy.cluster.hierarchy import fcluster, linkage
from scipy.spatial.distance import squareform

from ..seq import fastx
from ..seq.counts import KmerCounts
from ..utils import paths
from ..utils.io import smart_create, write_success
from ..utils.logging import get_logger

logger = get_logger("prune")


def add_args(p):
    p.add_argument("-d", "--db", required=True)
    p.add_argument("-l", "--loci", nargs="*", default=None)
    p.add_argument("-a", "--alignments", default="haplotypes.paf.gz",
                   help="PAF with pairwise alignments: a filename inside "
                        "each locus dir, or a path template with {} for the "
                        "locus name (prune.rs:72-78)")
    p.add_argument("-f", "--field", default="dv",
                   help="PAF tag carrying the divergence (prune.rs default "
                        "dv)")
    p.add_argument("-t", "--threshold", type=float, default=0.0002,
                   help="Divergence cut threshold (prune.rs default 0.0002)")
    p.add_argument("-n", "--n-clusters", type=int, default=None,
                   help="Dynamic threshold targeting ~this many clusters")
    p.add_argument("--power", type=float, default=2.0,
                   help="Power mean exponent for representative selection")
    p.add_argument("--newick", action="store_true",
                   help="Write the dendrogram as Newick")
    return p


def load_paf_divergences(path, names, field: str, repl_missing: float):
    """Symmetric divergence matrix from a PAF produced by `align`
    (prune.rs load_divergences:176-247): reads `field:f:` tags, missing
    pairs replaced with `repl_missing`."""
    from ..utils.io import smart_open
    name2id = {n: i for i, n in enumerate(names)}
    n = len(names)
    div = np.full((n, n), np.nan)
    np.fill_diagonal(div, 0.0)
    prefix = f"{field}:"
    n_rows = 0
    with smart_open(path) as f:
        for line in f:
            if isinstance(line, bytes):
                line = line.decode()
            split = line.rstrip("\n").split("\t")
            if len(split) < 12:
                continue
            i = name2id.get(split[0])
            j = name2id.get(split[5])
            if i is None or j is None or i == j:
                continue
            val = None
            for tag in split[12:]:
                if tag.startswith(prefix):
                    val = float(tag.split(":", 2)[2])
                    break
            if val is None or val < 0:
                continue
            n_rows += 1
            div[i, j] = div[j, i] = val
    missing = np.isnan(div)
    if missing.sum() == n * n - n:
        raise ValueError(f"{path}: divergence missing for all pairs")
    if missing.any():
        logger.warning("Divergence missing for %.1f%% of pairs; replacing "
                       "with %.5g", 100.0 * missing.sum() / max(n * n - n, 1),
                       repl_missing)
        div[missing] = repl_missing
    return div


def cluster_haplotypes(div: np.ndarray, threshold=None, n_clusters=None):
    """Complete-linkage clustering; returns cluster labels per haplotype."""
    n = div.shape[0]
    if n <= 1:
        return np.zeros(n, int), None
    Z = linkage(squareform(div, checks=False), method="complete")
    if n_clusters is not None:
        t = select_cut_threshold(Z, n, n_clusters)
        labels = fcluster(Z, t=t, criterion="distance")
    else:
        labels = fcluster(Z, t=threshold, criterion="distance")
    return labels - 1, Z


def select_cut_threshold(Z, n_haps: int, n_clusters: int) -> float:
    """Dynamic threshold targeting ~n_clusters clusters: the dissimilarity
    of merge step n_haps - n_clusters - 1 with steps sorted ascending
    (prune.rs select_cut_threshold:344-364)."""
    i = n_haps - n_clusters - 1
    if i < 0:
        logger.warning("There are %d haplotypes, <= the requested %d "
                       "clusters", n_haps, n_clusters)
        return 0.0
    heights = np.sort(Z[:, 2])
    t = float(heights[i])
    logger.info("Use cut threshold of %.6f", t)
    return t


def representative(div: np.ndarray, members: np.ndarray, power: float) -> int:
    """Member minimizing the power-mean of intra-cluster divergences
    (prune.rs:249-341, math/mod.rs PowerMean)."""
    if members.size == 1:
        return int(members[0])
    sub = div[np.ix_(members, members)]
    if power == np.inf:
        score = sub.max(axis=1)
    elif power == 0:
        score = np.exp(np.log(np.maximum(sub, 1e-12)).mean(axis=1))
    else:
        score = (np.power(sub, power).mean(axis=1)) ** (1.0 / power)
    return int(members[np.argmin(score)])


def to_newick(Z, names) -> str:
    from scipy.cluster.hierarchy import to_tree
    tree = to_tree(Z)

    def rec(node):
        if node.is_leaf():
            return names[node.id]
        return f"({rec(node.left)}:{node.dist / 2:.5f}," \
               f"{rec(node.right)}:{node.dist / 2:.5f})"
    return rec(tree) + ";"


def prune_locus(ldir: Path, threshold, n_clusters, power, newick,
                alignments="haplotypes.paf.gz", field="dv"):
    named = [(r.name, r.seq) for r in fastx.read_fastx_auto(ldir / paths.HAPLOTYPES)]
    names = [n for n, _ in named]
    # Prefer PAF CIGAR divergences (prune.rs:534-536); fall back to the
    # minimizer-Jaccard matrix from `add` when no alignment file exists.
    if "{}" in str(alignments):
        paf = Path(str(alignments).replace("{}", ldir.name))
    else:
        paf = ldir / alignments
    if paf.exists():
        repl = np.inf if n_clusters is not None else 10.0 * threshold
        div = load_paf_divergences(paf, names, field, repl)
    else:
        logger.info("[%s] no %s; falling back to minimizer divergences",
                    ldir.name, paf.name)
        div = np.load(ldir / paths.DISTANCES)["div"]
    labels, Z = cluster_haplotypes(div, threshold, n_clusters)
    keep = sorted({representative(div, np.nonzero(labels == c)[0], power)
                   for c in np.unique(labels)})
    logger.info("[%s] %d haplotypes -> %d clusters", ldir.name, len(names),
                len(keep))
    if len(keep) == len(names):
        return
    kept_names = [names[i] for i in keep]
    with smart_create(ldir / paths.HAPLOTYPES) as f:
        for i in keep:
            fastx.write_fasta(f, names[i], named[i][1])
    kc = KmerCounts.load_npz(ldir / paths.KMER_COUNTS).thin_out(keep)
    kc.save_npz(ldir / paths.KMER_COUNTS)
    np.savez_compressed(ldir / paths.DISTANCES, div=div[np.ix_(keep, keep)],
                        names=np.array(kept_names))
    with open(ldir / paths.DISCARDED, "a") as f:
        for c in np.unique(labels):
            members = np.nonzero(labels == c)[0]
            rep = representative(div, members, power)
            for m in members:
                if m != rep:
                    f.write(f"{names[m]}\t~\t{names[rep]}\n")
    if newick and Z is not None:
        (ldir / "clusters.nwk").write_text(to_newick(Z, names) + "\n")
    write_success(ldir)


def run(args):
    db = Path(args.db)
    loci = args.loci or sorted(
        d.name for d in (db / paths.LOCI_DIR).iterdir() if d.is_dir())
    for name in loci:
        prune_locus(paths.locus_dir(db, name), args.threshold,
                    args.n_clusters, args.power, args.newick,
                    args.alignments, args.field)
    return 0
