"""Multi-GPU execution: a grid of devices and sharded genotyping steps.

Counterpart of the reference package's parallel/mesh.py.  The reference is
a single-node multi-threaded CPU tool (SURVEY.md §2.3); its two worker pools
map onto a 2-axis grid of devices here:

* axis "read" (data parallel): read batches and the read×haplotype
  likelihood tensors are split by read; per-genotype filter scores are
  partial sums, one a shard of the read axis, added on the grid's first
  device in shard order (the reference's `psum`; recruit.rs:1103-1311,
  locs.rs:1120-1146);
* axis "gt" (task parallel): genotype×attempt chains are independent and
  split over the whole grid (solve.rs:969-1127).

One process drives every card of its host: a sharded call splits its batch
into contiguous slices, one a shard in the grid's row-major order, launches
each slice's work on its shard's device (the kernel wrappers enter that
device and take its current stream, so the shards run side by side), and
joins the outputs in shard order.  No `torch.distributed` here: across hosts
only loci are split (parallel/multihost.py).

A grid may name one device several times (`make_mesh(devices=["cpu"] * 4)`,
or four shards on one card): its shards then run one after the other on that
device, which exercises the split, the padding, each shard's launch and the
reduction, but no copy between cards.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.rng import derive_seed

AXES = ("read", "gt")


class Mesh:
    """A 2-D grid of `torch.device`s with axes ("read", "gt").

    `devices` is a numpy object array [n_read, n_gt]; `shape` maps each
    axis name to its length.  Shard `ix` is `devices.flat[ix]` (row-major:
    ix = read index · n_gt + gt index)."""

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError(f"a mesh needs a non-empty 2-D grid of devices, "
                             f"got shape {devices.shape}")
        types = {d.type for d in devices.flat}
        if len(types) != 1:
            raise ValueError(f"a mesh holds one type of device, got {types}")
        self.devices = devices

    @property
    def shape(self) -> dict:
        return dict(zip(AXES, self.devices.shape))

    @property
    def shards(self) -> list:
        """The device of every shard, in shard order."""
        return list(self.devices.flat)

    @property
    def distinct(self) -> list:
        """Each device of the grid once, in shard order."""
        return list(dict.fromkeys(self.devices.flat))

    @property
    def device_type(self) -> str:
        return self.devices.flat[0].type

    def __repr__(self):
        return f"Mesh({self.shape}, {[str(d) for d in self.shards]})"


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_devices: int | None = None, read_axis: int | None = None,
              devices=None) -> Mesh:
    """2-D grid {read × gt} over `devices` (default: every local card),
    the first `n_devices` of them.  By default 2 on the read axis when the
    count is even.  `devices` may repeat a device (several shards on one
    device, as the tests do with `["cpu"] * 4`)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    n = n_devices or len(devices)
    if not 0 < n <= len(devices):
        raise ValueError(f"a mesh of {n} devices from {len(devices)}")
    if read_axis is None:
        read_axis = 2 if n % 2 == 0 and n > 1 else 1
    if n % read_axis:
        raise ValueError(f"{n} devices do not split into {read_axis} rows")
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    return Mesh(grid.reshape(read_axis, n // read_axis))


def auto_mesh() -> Mesh | None:
    """Production grid: every local card when more than one is attached and
    their count is a power of two, else None (the one-device path, with no
    cost).  Only local cards: hosts split loci, never arrays
    (multihost.py)."""
    n = torch.cuda.device_count()
    if n > 1 and (n & (n - 1)) == 0:
        return make_mesh()
    return None


def resolve_mesh(mesh, device: torch.device) -> Mesh | None:
    """A Mesh or None as given; "auto" -> `auto_mesh()` (looked up at call
    time), kept only when its devices are of the run's type: a run that
    asked for the CPU does not go to the cards."""
    if isinstance(mesh, str):
        if mesh != "auto":
            raise ValueError(f"mesh must be a Mesh, None or 'auto', got "
                             f"{mesh!r}")
        mesh = auto_mesh()
        if mesh is not None and mesh.device_type != device.type:
            mesh = None
    return mesh


def shard_rows(mesh: Mesh, n_rows: int):
    """(rows a shard, padding rows): n_rows padded to a multiple of the
    shard count, split into equal contiguous slices."""
    pad = (-n_rows) % mesh.devices.size
    return (n_rows + pad) // mesh.devices.size, pad


def _pad_rows(arr: np.ndarray, pad: int, fill) -> np.ndarray:
    if not pad:
        return arr
    return np.concatenate(
        [arr, np.full((pad,) + arr.shape[1:], fill, arr.dtype)])


# ---------------------------------------------------------------------------
# Read-sharded alignment and recruitment (no randomness: equal to the one
# device's outputs to the bit)
# ---------------------------------------------------------------------------

def dispatch_sharded_align(mesh: Mesh, jobs, score_vec, band: int,
                           rows=None, staged: dict | None = None) -> list:
    """Dispatch half of `sharded_align`: jobs lo..hi (`rows`; all by
    default) of a job table (`model/locs.py:AlignJobs`), padded with N
    reads of length 0 in N windows to a multiple of the shard count, split
    in contiguous slices; each shard gathers its slice's reads and windows
    on its own device, from the table staged there once (`staged`: device
    -> `StagedJobs`, filled on first use), and aligns it.  Returns pending
    (result, event, rows kept) entries in shard order, for
    `model/locs.py:collect_align_batches`."""
    from ..model.locs import align_async

    lo, hi = rows if rows is not None else (0, len(jobs))
    staged = {} if staged is None else staged
    per, _ = shard_rows(mesh, hi - lo)
    pending = []
    for ix, dev in enumerate(mesh.shards):
        if dev not in staged:
            staged[dev] = jobs.stage(score_vec, band, dev)
        a = min(lo + ix * per, hi)
        b = min(a + per, hi)
        res, event = align_async(staged[dev], a, b, per)
        pending.append((res, event, b - a))
    return pending


def sharded_align(mesh: Mesh, jobs, score_vec, band: int = 48) -> dict:
    """Read-batch-sharded banded alignment (P3/P4 of SURVEY.md §2.3) of a
    job table: each shard aligns its slice with the local kernel
    (`ops/align.py:align_banded`), no collectives.  Returns {key: [N]
    numpy} like `model/locs.py:run_align_batches`, equal to it to the
    bit."""
    from ..model.locs import collect_align_batches
    return collect_align_batches(dispatch_sharded_align(
        mesh, jobs, score_vec, band))


class ShardedDecisions:
    """Packed recruitment decisions of one batch split over a grid: one
    `ops/recruit.py:PendingDecisions` a shard, joined in shard order and
    cut to the batch's rows."""

    def __init__(self, parts: list, n_rows: int):
        self.parts = parts
        self.n_rows = n_rows

    def numpy(self) -> np.ndarray:
        """[B, G] uint32 locus bitmaps on the host (waits for every
        shard's copy)."""
        return np.concatenate([p.numpy() for p in self.parts])[:self.n_rows]


def _dispatch_pairs(mesh: Mesh, cfg, tables: dict, reads1, reads2):
    from ..ops.recruit import PendingDecisions, _pairs_decide, _upload

    B = reads1.shape[0]
    per, pad = shard_rows(mesh, B)
    reads1 = _pad_rows(np.asarray(reads1), pad, 4)
    reads2 = _pad_rows(np.asarray(reads2), pad, 4)
    parts = []
    for ix, dev in enumerate(mesh.shards):
        sl = slice(ix * per, (ix + 1) * per)
        # Mates stay row-aligned within a shard: mate-1 rows, then
        # mate-2 rows of the same pairs.
        parts.append(PendingDecisions(_pairs_decide(
            cfg, _upload(dev, reads1[sl], reads2[sl]), *tables[dev])))
    return ShardedDecisions(parts, B)


def _tables_on(mesh: Mesh, keys_signed, packed) -> dict:
    """The two lookup tables (int32 bit patterns) on each distinct device."""
    ks = torch.as_tensor(np.asarray(keys_signed).view(np.int32))
    pk = torch.as_tensor(np.ascontiguousarray(packed).view(np.int32))
    return {dev: (ks.to(dev), pk.to(dev)) for dev in mesh.distinct}


def sharded_recruit_pairs(mesh: Mesh, cfg, reads1, reads2, keys_signed,
                          packed) -> np.ndarray:
    """Read-batch-sharded pair recruitment (P1 of SURVEY.md §2.3): the
    [B, L] batches split over the grid; each shard decides its slice with
    the local kernel, no collectives (recruit.rs:1103-1311).  (keys_signed,
    packed) are `DeviceIndex.keys_signed` and `DeviceIndex.packed`.
    Returns the packed [B, n_groups] uint32 decisions."""
    tables = _tables_on(mesh, keys_signed, packed)
    return _dispatch_pairs(mesh, cfg, tables, reads1, reads2).numpy()


class MeshPairRecruiter:
    """Persistent grid-sharded pair recruitment for the production fast
    path: the index tables go to each distinct device ONCE; each batch is
    split, uploaded from pinned memory to each shard's device and decided
    there by `_pairs_decide`.  Decisions equal the one-device path's to the
    bit (tests/test_torch_mesh.py)."""

    def __init__(self, mesh: Mesh, index):
        self.mesh = mesh
        self.cfg = index.cfg
        self._tables = {dev: index.device_args(dev) for dev in mesh.distinct}

    def run_async(self, reads1: np.ndarray,
                  reads2: np.ndarray) -> ShardedDecisions:
        """[B, L] mate batches -> pending [B, n_groups] bitmaps."""
        return _dispatch_pairs(self.mesh, self.cfg, self._tables, reads1,
                               reads2)


# ---------------------------------------------------------------------------
# The solver: read-sharded stage-0 filter, genotype-sharded stages
# ---------------------------------------------------------------------------

def sharded_filter_scores(mesh: Mesh, best_aln, genotypes,
                          priors) -> np.ndarray:
    """Stage-0 filter with reads split over the "read" axis:
    score[g] = prior[g] + Σ_r max_h∈gt best_aln[h, r] (genotypes [G, P]),
    float32.  Each read shard (on the first device of its row of the grid)
    sums its slice; the partial sums are moved to the grid's first device
    and added in shard order (solve.rs:87-122 redistributed).  The read
    count must be a multiple of the read axis (pad with zeros: they shift
    every score equally)."""
    best_aln = torch.as_tensor(np.asarray(best_aln, np.float32))
    genotypes = torch.as_tensor(np.asarray(genotypes)).long()
    n_read = mesh.shape["read"]
    R = best_aln.shape[1]
    if R % n_read:
        raise ValueError(f"{R} reads do not split over {n_read} read shards")
    per = R // n_read
    first = mesh.shards[0]
    partials = []
    for r in range(n_read):
        dev = mesh.devices[r, 0]
        ba = best_aln[:, r * per:(r + 1) * per].to(dev)
        gts = genotypes.to(dev)
        gt_best = ba[gts[:, 0]]
        for p in range(1, gts.shape[1]):
            gt_best = torch.maximum(gt_best, ba[gts[:, p]])
        partials.append(gt_best.sum(dim=1))
    total = partials[0].to(first)
    for part in partials[1:]:
        total = total + part.to(first)
    prior = torch.as_tensor(np.asarray(priors, np.float32)).to(first)
    return (prior + total).cpu().numpy()


def sharded_stage_solver(mesh: Mesh, run_solver, seed: int, gts):
    """Genotype-sharded solver stage: the [G, P] genotype chunk (padded
    with its last row to a multiple of the shard count) splits over the
    WHOLE grid and each shard runs the stage engine on its rows on its
    device (the reference's solver worker pool, solve.rs:969-1127).

    `run_solver(seed, gts, device) -> (liks [g, A], assgns [g, A, R])`.
    Shard `ix` runs with `derive_seed(seed, "shard", ix)`, so chains stay
    independent across shards (the reference folds the shard index into
    its key).  Returns (liks [G, A], assgns [G, A, R]) on the grid's first
    device, joined in shard order."""
    gts = np.asarray(gts)
    G = gts.shape[0]
    per, pad = shard_rows(mesh, G)
    if pad:
        gts = np.concatenate([gts, np.repeat(gts[-1:], pad, 0)])
    first = mesh.shards[0]
    liks, assgns = [], []
    for ix, dev in enumerate(mesh.shards):
        lik, assgn = run_solver(derive_seed(seed, "shard", ix),
                                gts[ix * per:(ix + 1) * per], dev)
        liks.append(lik)
        assgns.append(assgn)
    return (torch.cat([t.to(first) for t in liks])[:G],
            torch.cat([t.to(first) for t in assgns])[:G])


def solver_args_on(devices, hap_prob, hap_mid, unmapped_prob, pack_nwin,
                   pack_regstart, pack_len, gc_at, weight_at, bayes) -> dict:
    """The 9 array operands of a solver call, one copy on each device."""
    f32, i32 = torch.float32, torch.int32
    args = ((hap_prob, f32), (hap_mid, i32), (unmapped_prob, f32),
            (pack_nwin, i32), (pack_regstart, i32), (pack_len, i32),
            (gc_at, i32), (weight_at, f32), (bayes, f32))
    host = tuple(torch.as_tensor(np.asarray(a)).to(dt) for a, dt in args)
    return {dev: tuple(t.to(dev) for t in host) for dev in devices}


def sharded_solve(mesh: Mesh, seed: int, genotypes, hap_prob, hap_mid,
                  unmapped_prob, pack_nwin, pack_regstart, pack_len, gc_at,
                  weight_at, bayes, cfg, n_attempts: int, max_windows: int,
                  random_init: bool = True) -> np.ndarray:
    """Genotype-sharded chains of the sequential engine (`ops/solver.py:
    solve_genotypes`), the genotype batch split over the whole grid.  The
    engine counts its draws by genotype row, and each shard passes its
    first row: the result equals the one-device call's to the bit.
    Returns liks [G, A] (numpy)."""
    from ..ops.solver import solve_genotypes

    genotypes = np.asarray(genotypes)
    G = genotypes.shape[0]
    per, pad = shard_rows(mesh, G)
    if pad:
        genotypes = np.concatenate([genotypes,
                                    np.repeat(genotypes[-1:], pad, 0)])
    args = solver_args_on(mesh.distinct, hap_prob, hap_mid, unmapped_prob,
                          pack_nwin, pack_regstart, pack_len, gc_at,
                          weight_at, bayes)
    liks = []
    for ix, dev in enumerate(mesh.shards):
        lik, _ = solve_genotypes(
            seed, genotypes[ix * per:(ix + 1) * per], *args[dev], cfg,
            n_attempts=n_attempts, max_windows=max_windows,
            random_init=random_init, first_row=ix * per, device=dev)
        liks.append(lik)
    return np.concatenate([t.cpu().numpy() for t in liks])[:G]


def full_step(mesh: Mesh, seed: int, tensors, pack, bayes, genotypes, priors,
              cfg, n_attempts: int = 2):
    """One full sharded genotyping step: read-sharded filter +
    genotype-sharded chains (the multi-device dry run of
    `__graft_entry__.dryrun_multichip`).  Returns (scores [G], liks
    [G, A]) as numpy."""
    best_aln = np.maximum(np.asarray(tensors.hap_prob).max(axis=2),
                          np.asarray(tensors.unmapped_prob)[None, :])
    pad_r = (-best_aln.shape[1]) % mesh.shape["read"]
    scores = sharded_filter_scores(mesh, np.pad(best_aln, ((0, 0), (0, pad_r))),
                                   genotypes, priors)
    liks = sharded_solve(
        mesh, seed, genotypes, tensors.hap_prob, tensors.hap_mid,
        tensors.unmapped_prob, pack.n_windows, pack.reg_start,
        pack.contig_len, pack.gc_at, pack.weight_at, bayes, cfg,
        n_attempts=n_attempts, max_windows=pack.max_windows)
    return scores, liks
