"""PyTorch port of device recruitment vs the JAX package, on the CPU.

The same numpy inputs go through `locityper_tpu_torch.ops.recruit`
(`device="cpu"`: the plain PyTorch version of the minimizer front end) and
through the JAX package: its two Pallas kernels in TPU interpret mode, its
XLA path, and its host engine.  Everything here is integers, so every
comparison is for equality; there is no tolerance.
"""
import jax  # noqa: F401  (conftest pins it to the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from locityper_tpu import sim
from locityper_tpu.ops import recruit as JR
from locityper_tpu.seq import dna
from locityper_tpu.seq.contigs import ContigSet
from locityper_tpu.seq.counts import GenomeKmerCounter, off_target_counts
from locityper_tpu.seq.recruit import (RecruitParams, TargetIndex,
                                       recruit_long_read, recruit_read_pair,
                                       recruit_short_read)
from locityper_tpu_torch import convert
from locityper_tpu_torch.ops import recruit as TR
from locityper_tpu_torch.seq import recruit as TSR

torch.set_num_threads(1)        # the suite runs several workers side by side

BIG = 0x7FFFFFFF


def t8(reads):
    return torch.from_numpy(np.ascontiguousarray(reads, np.int8))


def xla_front(reads, k, w):
    """(hs signed view, is_fw, mask) of the JAX package's XLA path."""
    h, is_fw = JR._canonical_hashes(jnp.asarray(reads), k)
    mask = JR._minimizer_mask(h, w)
    hs = (h ^ jnp.uint32(JR.SIGN_BIT)).astype(jnp.int32)
    return hs, is_fw, mask


# --- the front end ----------------------------------------------------------

@pytest.mark.parametrize("B,L,S_override,n_frac", [
    (256, 152, None, 0.0),
    (256, 152, 8, 0.0),         # truncating
    (512, 251, 16, 0.0),        # truncating
    (256, 64, None, 0.1),       # with Ns
    (256, 192, None, 0.02),     # the main path's width
])
def test_compacting_front_equals_pallas_and_xla(B, L, S_override, n_frac):
    rng = np.random.default_rng(1)
    k, w = 15, 10
    reads = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    if n_frac:
        reads[rng.random((B, L)) < n_frac] = 4
    reads[:8, 40:60] = 4
    reads[8] = 2                # one repeated base: every hash ties
    reads[9, :L // 2] = 1
    P = L - k + 1
    S = S_override or TR._front_S(P, w)
    assert S == (S_override or min(P, max(4 * (P // (w + 1)) + 16, 16)))

    hs, is_fw, mask = xla_front(reads, k, w)
    total_x = np.asarray(jnp.sum(mask, axis=1)).astype(np.int32)
    order = jnp.argsort(~mask, axis=1, stable=True)[:, :S]
    hx, fx, mx = (np.asarray(jnp.take_along_axis(a, order, axis=1))
                  for a in (hs, is_fw, mask))
    with pltpu.force_tpu_interpret_mode():
        hc, fc, mc, tot = map(np.asarray, JR._front_compact_pallas(
            jnp.asarray(reads), k, w, S))

    th, tf, tm, tt = (a.numpy() for a in
                      TR.minimizer_front(t8(reads), k, w, S))
    assert th.dtype == np.int32 and tt.dtype == np.int32
    assert tf.dtype == np.bool_ and tm.dtype == np.bool_
    # The Pallas kernel, on every output and every column.
    np.testing.assert_array_equal(tm, mc)
    np.testing.assert_array_equal(tt, tot)
    np.testing.assert_array_equal(th, hc)
    np.testing.assert_array_equal(tf, fc)
    # The XLA argsort path, where masked.
    np.testing.assert_array_equal(tm, mx)
    np.testing.assert_array_equal(tt, total_x)
    np.testing.assert_array_equal(np.where(tm, th, 0), np.where(mx, hx, 0))
    np.testing.assert_array_equal(tf & tm, fx & mx)
    # Columns the mask does not select hold the undefined hash.
    assert (th[~tm] == BIG).all() and not tf[~tm].any()
    if S_override:
        assert (tt > S).any(), "no row was truncated"


@pytest.mark.parametrize("L", [152, 192, 256, 1024])
def test_full_width_front_equals_xla_and_pallas(L):
    rng = np.random.default_rng(L)
    B, k, w = 256, 15, 10
    reads = rng.integers(0, 5, (B, L)).astype(np.int8)      # incl. Ns
    reads[:4] = rng.integers(0, 4, (4, L))
    reads[4] = 0                                            # all ties
    reads[5, 30:90] = 4                                     # a run of N
    hx, fx, mx = map(np.asarray, xla_front(reads, k, w))
    th, tf, tm = (a.numpy() for a in TR.minimizer_front(t8(reads), k, w))
    assert th.shape == (B, L - k + 1)
    np.testing.assert_array_equal(th, hx)
    np.testing.assert_array_equal(tm, mx)
    np.testing.assert_array_equal(tf, fx)
    assert tm.any() and not tm[th == BIG].any()
    if L <= 512:            # the TPU kernel's own row limit
        with pltpu.force_tpu_interpret_mode():
            hp, fp, mp = map(np.asarray, JR._hash_mask_pallas(
                jnp.asarray(reads), k, w))
        np.testing.assert_array_equal(th, hp)
        np.testing.assert_array_equal(tm, mp)
        np.testing.assert_array_equal(tf, fp)


@pytest.mark.parametrize("k,w,L", [(15, 10, 15), (15, 10, 20), (11, 5, 40),
                                   (7, 1, 30), (15, 20, 33)])
def test_front_small_shapes_and_other_parameters(k, w, L):
    """Rows shorter than a window, w = 1, and B that is no multiple of
    anything."""
    rng = np.random.default_rng(k * 100 + w)
    reads = rng.integers(0, 5, (37, L)).astype(np.int8)
    reads[:20] = rng.integers(0, 4, (20, L))
    hx, fx, mx = map(np.asarray, xla_front(reads, k, w))
    th, tf, tm = (a.numpy() for a in TR.minimizer_front(t8(reads), k, w))
    np.testing.assert_array_equal(th, hx)
    np.testing.assert_array_equal(tm, mx)
    np.testing.assert_array_equal(tf, fx)
    S = L - k + 1 + 3           # more columns than positions
    ch, cf, cm, ct = (a.numpy() for a in
                      TR.minimizer_front(t8(reads), k, w, S))
    assert ch.shape == (37, S)
    np.testing.assert_array_equal(ct, mx.sum(axis=1))
    np.testing.assert_array_equal(cm.sum(axis=1), mx.sum(axis=1))
    for i in range(37):
        np.testing.assert_array_equal(ch[i, :ct[i]], hx[i][mx[i]])
        np.testing.assert_array_equal(cf[i, :ct[i]], fx[i][mx[i]])


@pytest.mark.parametrize("k,w", [(16, 10), (16, 1), (16, 25)])
def test_front_at_k16_equals_the_xla_path(k, w):
    """At k = 16 the k-mers fill 32 bits (`genotype -m 16,10`): the JAX
    package's CPU path (`_hash_mask`, XLA) and the port's plain version agree
    bit for bit on hs, is_fw and mask, with N in the reads, and the
    compacting entry keeps the same minimizers."""
    rng = np.random.default_rng(16 + w)
    reads = rng.integers(0, 4, (64, 192)).astype(np.int8)
    reads[rng.random(reads.shape) < 0.01] = 4
    reads[0] = 2
    reads[1, 50:90] = 4
    reads[2] = 3
    hs, is_fw, mask = map(np.asarray, JR._hash_mask(jnp.asarray(reads), k, w))
    th, tf, tm = (a.numpy() for a in TR.minimizer_front(t8(reads), k, w))
    np.testing.assert_array_equal(th, hs)
    np.testing.assert_array_equal(tf, is_fw)
    np.testing.assert_array_equal(tm, mask)
    assert mask.any() and (th == BIG).any()
    S = TR._front_S(192 - k + 1, w)
    ch, cf, cm, ct = (a.numpy() for a in TR.minimizer_front(t8(reads), k, w,
                                                           S))
    np.testing.assert_array_equal(ct, mask.sum(axis=1))
    for i in range(reads.shape[0]):
        n = min(int(ct[i]), S)
        np.testing.assert_array_equal(ch[i, :n], hs[i][mask[i]][:n])
        np.testing.assert_array_equal(cf[i, :n], is_fw[i][mask[i]][:n])


def test_front_rejects_what_the_kernel_does_not_take():
    reads = t8(np.zeros((4, 40), np.int8))
    with pytest.raises(ValueError, match="k <= 16"):
        TR.minimizer_front(reads, 17, 10)
    with pytest.raises(ValueError, match="hold no 15-mer"):
        TR.minimizer_front(reads[:, :14], 15, 10)
    with pytest.raises(ValueError, match="int8"):
        TR.minimizer_front(reads.to(torch.int32), 15, 10)
    with pytest.raises(ValueError, match="S must be positive"):
        TR.minimizer_front(reads, 15, 10, 0)


def test_minimizers_equal_the_host_engine():
    """Masked positions, hashes and directions equal seq/kmers.py's
    minimizers32 on the same read (the host engine's front end)."""
    from locityper_tpu_torch.seq.kmers import minimizers32
    rng = np.random.default_rng(3)
    reads = rng.integers(0, 4, (6, 300)).astype(np.int8)
    reads[2, 100:130] = 4
    th, tf, tm = (a.numpy() for a in TR.minimizer_front(t8(reads), 15, 10))
    for i in range(6):
        pos, vals, fwd = minimizers32(reads[i], 15, 10)
        np.testing.assert_array_equal(np.nonzero(tm[i])[0], pos)
        raw = (th[i][tm[i]].astype(np.int64) + 2**31).astype(np.uint32)
        np.testing.assert_array_equal(raw, vals)
        np.testing.assert_array_equal(tf[i][tm[i]], fwd)


# --- the CUDA kernel's schedule, walked on the CPU --------------------------

def schedule_model(hs, is_fw, w, S, chunk, lanes):
    """numpy walk of minimizer_front.cu's schedule over the plain version's
    hashes and directions [B, P]: chunks of `chunk` positions, each staged
    with halos of w - 1 hashes (BIG past the row's edges); keys (unsigned
    hash << 32 | staged index), log2 w passes that leave the least key of
    every span of 2^j, and each window of w inside the row and touching the
    chunk marking the least of two overlapping spans; positions striped
    over `lanes` lanes, Q = chunk / lanes steps a chunk, a step's set lanes
    ranked by ballot + popcount, the count carried from chunk to chunk and
    the writes cut at S.  Returns (mask [B, P], and the compacting entry's
    hs, is_fw, mask [B, S] and total [B])."""
    B, P = hs.shape
    halo = w - 1
    span_log = w.bit_length() - 1
    rows = np.arange(B)[:, None]
    lane = np.arange(lanes)
    mask = np.zeros((B, P), bool)
    out_h = np.full((B, S), BIG, np.int32)
    out_f = np.zeros((B, S), bool)
    out_m = np.zeros((B, S), bool)
    count = np.zeros(B, np.int64)
    for c0 in range(0, P, chunk):
        n = min(chunk, P - c0)
        q0 = c0 - halo
        q = np.arange(q0, c0 + n + halo)
        inside = (q >= 0) & (q < P)
        staged = np.full((B, q.size), BIG, np.int64)
        staged[:, inside] = hs[:, q[inside]]
        key = ((staged + 2**31).astype(np.uint64) << np.uint64(32)) \
            | np.arange(q.size, dtype=np.uint64)
        for j in range(1, span_log + 1):
            d = 1 << (j - 1)
            last = q.size - 2 * d
            key[:, :last + 1] = np.minimum(key[:, :last + 1],
                                           key[:, d:last + 1 + d])
        marked = np.zeros((B, q.size), bool)
        s = np.arange(max(0, c0 - halo), min(c0 + n - 1, P - w) + 1) - q0
        if s.size:
            least = np.minimum(key[:, s], key[:, s + w - (1 << span_log)])
            marked[rows, (least & np.uint64(0xFFFFFFFF)).astype(np.int64)] = 1
        for j0 in range(0, n, lanes):
            j = j0 + lane
            live = j < n
            p = c0 + np.minimum(j, n - 1)
            c = np.minimum(j, n - 1) + halo         # the position in `staged`
            h = staged[:, c]
            m = live & marked[:, c] & (h != BIG)
            mask[:, c0 + j[live]] = m[:, live]
            rank = count[:, None] + np.cumsum(m, axis=1) - m   # popc below
            put = m & (rank < S)
            r_ix, _ = np.nonzero(put)
            out_h[r_ix, rank[put]] = h[put]
            out_f[r_ix, rank[put]] = is_fw[rows, p[None, :]][put]
            out_m[r_ix, rank[put]] = True
            count += m.sum(axis=1)
    return mask, out_h, out_f, out_m, count.astype(np.int32)


def schedule_reads(B, L, seed):
    """Random codes with N at chunk boundaries (64, 96, 256, 512), a run of
    N, negative int8 codes and a row of one repeated base."""
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, 4, (B, L)).astype(np.int8)
    reads[rng.random((B, L)) < 0.01] = 4
    for b in (64, 96, 256, 512):
        if b < L:
            reads[1, b] = 4
            reads[2, b - 1] = 4
    reads[3, L // 3:L // 2] = 4
    reads[4, ::7] = -1
    reads[4, 3::11] = -128
    reads[B - 1] = 2
    return reads


@pytest.mark.parametrize("chunk,lanes", [(256, 32), (96, 32), (32, 32),
                                         (64, 8)])
@pytest.mark.parametrize("L,w,S", [
    (700, 10, 100),     # the S cut falls in a later chunk
    (700, 40, 30),
    (40, 10, 12),       # P < 32
    (15, 10, 4),        # P = 1
    (20, 10, 8),        # w > P
    (300, 1, 400),      # w = 1, S > P
])
def test_kernel_schedule_equals_plain_compaction(chunk, lanes, L, w, S):
    """The kernel's chunked, striped walk gives the plain version's mask,
    and its ballot rank gives the plain version's compaction exactly."""
    k = 15
    reads = schedule_reads(9, L, L + w)
    hs, is_fw, mask = (a.numpy() for a in TR._hash_mask_reference(
        t8(reads), k, w))
    got_mask, *got = schedule_model(hs, is_fw, w, S, chunk, lanes)
    np.testing.assert_array_equal(got_mask, mask)
    want = [a.numpy() for a in TR.minimizer_front_reference(t8(reads), k,
                                                            w, S)]
    for name, a, b in zip(("hs", "is_fw", "mask", "total"), got, want):
        np.testing.assert_array_equal(a, b, err_msg=name)
    if L == 700 and w == 10:
        # At least one row keeps minimizers of a later chunk and drops some.
        cut = np.argmax(np.cumsum(mask, axis=1) >= S, axis=1)
        assert ((want[3] > S) & (cut >= chunk)).any()


def rolling_model(reads, k, w, chunk, lanes):
    """numpy walk of the kernel's rolling k-mers: each chunk stages codes
    q0 = c0 - (w - 1) onwards (4 past the row's edges, int8 read as a byte),
    and lane l rolls the hashes of staged positions l * run ... l * run +
    run - 1, run = ceil((n + 2 (w - 1)) / lanes) made odd: k - 1 codes fill
    the k-mer, then one code a position, an invalid code entering as 0 and
    restarting the run of valid codes.  Returns (hs, is_fw) [B, P] as the
    lanes leave them for the positions of the row; asserts that every
    position past the row's edges comes out BIG."""
    B, L = reads.shape
    P, halo = L - k + 1, w - 1
    kmask = (1 << 2 * k) - 1
    hs = np.zeros((B, P), np.int64)
    is_fw = np.zeros((B, P), bool)
    for c0 in range(0, P, chunk):
        n = min(chunk, P - c0)
        q0 = c0 - halo
        run = -(-(n + 2 * halo) // lanes) | 1
        pos = q0 + np.arange(lanes * run + k - 1)
        inrow = (pos >= 0) & (pos < L)
        staged = np.full((B, pos.size), 4, np.int64)
        staged[:, inrow] = reads[:, pos[inrow]].astype(np.int64) & 0xFF
        for lane in range(lanes):
            fw = np.zeros(B, np.int64)
            rv = np.zeros(B, np.int64)
            valid_run = np.zeros(B, np.int64)
            for t in range(run + k - 1):
                c = staged[:, lane * run + t]
                valid = c < 4
                c = np.where(valid, c, 0)
                fw = ((fw << 2) | c) & kmask
                rv = (rv >> 2) | ((3 - c) << 2 * (k - 1))
                valid_run = np.where(valid, valid_run + 1, 0)
                if t < k - 1:
                    continue
                q = q0 + lane * run + t - (k - 1)
                ok = valid_run >= k
                if not 0 <= q < P:
                    assert not ok.any(), q
                    continue
                x = ~np.where(fw <= rv, fw, rv) & 0xFFFFFFFF
                x ^= x >> 16
                x = (x * 0x85EBCA6B) & 0xFFFFFFFF
                x ^= x >> 13
                hs[:, q] = np.where(ok, x - 2**31, BIG)
                is_fw[:, q] = fw <= rv
    return hs.astype(np.int32), is_fw


@pytest.mark.parametrize("chunk,lanes", [(256, 32), (32, 32), (64, 8)])
@pytest.mark.parametrize("L,k,w", [(700, 15, 10), (301, 11, 40), (40, 15, 10),
                                   (15, 15, 10), (20, 15, 10), (90, 7, 1),
                                   (700, 16, 10), (16, 16, 10)])
def test_kernel_rolling_kmers_equal_plain_hashes(chunk, lanes, L, k, w):
    """hs and is_fw of the rolled k-mers equal the plain version's at every
    position, invalid ones included (is_fw is defined there, from the codes
    read as 0), with N at the starts and ends of the lanes' runs."""
    reads = schedule_reads(9, L, 7 * L + w)
    run = -(-(min(chunk, L - k + 1) + 2 * (w - 1)) // lanes) | 1
    for i, r in enumerate(range(5, 9)):     # N where a lane's run starts
        for p in range(i * (k - 1) - (w - 1), L, run * (i + 2)):
            if p >= 0:
                reads[r, p] = 4
    want = [a.numpy() for a in TR._hash_mask_reference(t8(reads), k, w)[:2]]
    got = rolling_model(reads, k, w, chunk, lanes)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert (want[0] == BIG).any() or L - k + 1 < 2


# --- the index and the packed decisions -------------------------------------

def build_world(seed=0, locus_len=4000, genome_len=60000, n_haps=4):
    rng = np.random.default_rng(seed)
    genome = sim.random_genome(rng, genome_len).copy()
    start = genome_len // 2
    locus = sim.simulate_locus(rng, length=locus_len, n_haps=n_haps,
                               divergence=0.02)
    ref = locus.haplotypes[0]
    genome[start:start + ref.size] = ref[:genome_len - start]
    counter = GenomeKmerCounter(25)
    counter.add_seq(genome)
    counter.finalize()
    kc = off_target_counts(counter, locus.haplotypes,
                           genome[start:start + ref.size])
    cset = ContigSet("locus", locus.hap_names, locus.haplotypes)
    return rng, genome, locus, cset, kc


def two_locus_index(seed, params):
    rng = np.random.default_rng(seed)
    genome = sim.random_genome(rng, 30000)
    counter = GenomeKmerCounter(25)
    counter.add_seq(genome)
    counter.finalize()
    idx = TargetIndex(params)
    loci = []
    for name in "AB":
        locus = sim.simulate_locus(rng, name, length=2500, n_haps=3)
        kc = off_target_counts(counter, locus.haplotypes,
                               np.empty(0, dtype=np.int8))
        idx.add_locus(ContigSet(name, locus.hap_names, locus.haplotypes), kc)
        loci.append(locus)
    idx.finalize()
    return rng, genome, loci, idx


@pytest.fixture(scope="module")
def world():
    return build_world()


@pytest.fixture(scope="module")
def index(world):
    _, _, _, cset, kc = world
    idx = TargetIndex(RecruitParams(match_frac=0.5))
    idx.add_locus(cset, kc)
    idx.finalize()
    return idx


def both_indexes(idx):
    """(JAX DeviceIndex, the port's built from the same TargetIndex fields,
    the port's converted from the JAX one)."""
    jdev = JR.DeviceIndex.from_index(idx)
    tidx = TSR.TargetIndex(TSR.RecruitParams(**vars(idx.params)),
                           keys=idx.keys, offsets=idx.offsets,
                           entry_locus=idx.entry_locus,
                           entry_info=idx.entry_info, n_loci=idx.n_loci)
    return jdev, TR.DeviceIndex.from_index(tidx), \
        convert.device_index_from_reference(jdev)


def assert_same_index(a, b):
    for f in ("keys", "fw_mask", "bw_mask", "rare_mask", "packed",
              "keys_signed"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    for f in ("n_loci", "n_groups", "k", "w", "frac_p", "frac_q"):
        assert getattr(a, f) == getattr(b, f), f


@pytest.mark.parametrize("n_loci", [1, 2])
def test_device_index_equals_reference(index, n_loci):
    idx = index if n_loci == 1 else \
        two_locus_index(21, RecruitParams(match_frac=0.5))[3]
    jdev, tdev, conv = both_indexes(idx)
    assert idx.keys.size > 100 and jdev.n_loci == n_loci
    assert_same_index(tdev, jdev)
    assert_same_index(conv, jdev)
    assert convert.from_reference(jdev).keys.size == jdev.keys.size
    keys, packed = tdev.device_args("cpu")
    assert keys.dtype == torch.int32 and packed.dtype == torch.int32
    assert tdev.device_args("cpu")[0] is keys       # uploaded once
    assert (keys[1:] > keys[:-1]).all()


def many_loci_index(n_loci=40, seed=4):
    """(TargetIndex, the loci's sequences): n_loci loci of 700 bp, each a
    random 400 bp followed by 300 bp that all loci share."""
    rng = np.random.default_rng(seed)
    idx = TargetIndex(RecruitParams(match_frac=0.5))
    shared = sim.random_genome(rng, 300)
    seqs = []
    for i in range(n_loci):
        seq = np.concatenate([sim.random_genome(rng, 400), shared])
        kc = type("KC", (), {"k": 25, "counts": [
            rng.integers(0, 20, seq.size - 24).astype(np.uint16)]})()
        idx.add_locus(ContigSet(f"L{i}", [f"h{i}"], [seq]), kc)
        seqs.append(seq)
    idx.finalize()
    return idx, seqs


@pytest.mark.parametrize("n_loci,n_groups", [(40, 2), (100, 4)])
def test_device_index_many_loci_spans_groups(n_loci, n_groups):
    """40 and 100 loci: two and four bitmap words per key, some keys shared
    by all loci."""
    idx, _ = many_loci_index(n_loci)
    jdev, tdev, _ = both_indexes(idx)
    assert tdev.n_groups == n_groups and idx.max_entries_per_key == n_loci
    assert_same_index(tdev, jdev)


@pytest.mark.parametrize("B,n_loci", [(16, 1), (64, 31), (64, 32), (32, 33),
                                      (8, 100)])
def test_packed_decisions_roundtrip(B, n_loci):
    rng = np.random.default_rng(2)
    dec = rng.random((B, n_loci)) < 0.2
    dec[0] = True                                   # bit 31 set: sign wrap
    packed = TR._pack_decisions(torch.from_numpy(dec))
    assert packed.shape == (B, max(-(-n_loci // 32), 1))
    assert packed.dtype == torch.int32
    want = np.asarray(JR._pack_decisions(jnp.asarray(dec)))
    np.testing.assert_array_equal(packed.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(
        TR.unpack_decisions(packed.numpy(), n_loci), dec)
    np.testing.assert_array_equal(
        TR.unpack_decisions(TR.PendingDecisions(packed).numpy(), n_loci), dec)
    np.testing.assert_array_equal(TR.unpack_decisions(dec, n_loci), dec)


def test_max_subarray_equals_sequential_kadane():
    rng = np.random.default_rng(5)
    v = rng.integers(-3, 5, (7, 90, 4)).astype(np.int32)
    v[0] = -1                                       # all negative: best is 0
    v[1] = 2                                        # all positive: the sum
    got = TR._max_subarray(torch.from_numpy(v)).numpy()
    want = np.zeros((7, 4), np.int64)
    for b in range(7):
        for n in range(4):
            best = cur = 0
            for x in v[b, :, n]:
                cur = max(cur + int(x), 0)
                best = max(best, cur)
            want[b, n] = best
    np.testing.assert_array_equal(got, want)
    assert (got[0] == 0).all() and (got[1] == 180).all()


# --- decisions: the port == the JAX package == the host engine --------------

def batch(reads, L):
    out = np.full((len(reads), L), 4, np.int8)
    for i, r in enumerate(reads):
        out[i, :min(r.size, L)] = r[:L]
    return out


def test_run_short_equals_reference_and_host(world, index):
    rng, genome, locus, _, _ = world
    jdev, tdev, _ = both_indexes(index)
    reads = sim.simulate_paired_reads(
        rng, [locus.haplotypes[i] for i in locus.true_genotype], depth=2)
    mix = reads.reads1[:60] + [genome[s:s + 150]
                               for s in range(3000, 12000, 150)]
    m = batch(mix, 160)
    got = TR.run_short(tdev, m, device="cpu")
    np.testing.assert_array_equal(got, JR.run_short(jdev, m))
    for i, r in enumerate(mix):
        assert sorted(np.nonzero(got[i])[0].tolist()) == \
            recruit_short_read(index, r), i
    assert 0 < got.sum() < len(mix)
    # A width that is no multiple of 8 or 64, and a batch of one.
    got1 = TR.run_short(tdev, batch(mix[:1], 151), device="cpu")
    np.testing.assert_array_equal(got1, got[:1])


def test_run_pairs_equals_reference_and_host(world, index):
    rng, genome, locus, _, _ = world
    jdev, tdev, _ = both_indexes(index)
    reads = sim.simulate_paired_reads(
        rng, [locus.haplotypes[i] for i in locus.true_genotype], depth=2)
    n = min(60, len(reads.reads1))
    r1 = reads.reads1[:n] + [genome[s:s + 150] for s in range(0, 3000, 150)]
    r2 = reads.reads2[:n] + [genome[s:s + 150] for s in range(400, 3400, 150)]
    # Mixed pairs: a locus mate with a background mate must be rejected.
    r1 += reads.reads1[:5]
    r2 += [genome[s:s + 150] for s in range(20000, 20750, 150)]
    m1, m2 = batch(r1, 160), batch(r2, 160)
    m1[rng.integers(0, n, 20), rng.integers(0, 150, 20)] = 4         # Ns
    got = TR.run_pairs(tdev, m1, m2, device="cpu")
    np.testing.assert_array_equal(got, JR.run_pairs(jdev, m1, m2))
    for i in range(len(r1)):
        host = recruit_read_pair(index, m1[i, :r1[i].size], r2[i])
        assert sorted(np.nonzero(got[i])[0].tolist()) == host, i
    assert 0 < got.sum() < len(r1)


def test_run_short_two_loci(world):
    rng, genome, loci, idx = two_locus_index(
        21, RecruitParams(match_frac=0.5))
    jdev, tdev, conv = both_indexes(idx)
    reads = [loci[0].haplotypes[0][300:450], loci[1].haplotypes[2][300:450],
             genome[100:250]]
    m = batch(reads, 160)
    for dev in (tdev, conv):
        got = TR.run_short(dev, m, device="cpu")
        assert got.tolist() == [[True, False], [False, True], [False, False]]
    np.testing.assert_array_equal(got, JR.run_short(jdev, m))


@pytest.mark.parametrize("n_loci", [40, 100])
@pytest.mark.parametrize("kind", ["pairs", "short"])
def test_many_loci_decisions_equal_reference_and_host(kind, n_loci):
    """Decisions over two and four bitmap words a key: three pairs from
    every locus, background pairs, and a pair with one mate off the loci.
    The host engine reads the rows as the device does, N padding included."""
    idx, seqs = many_loci_index(n_loci)
    jdev, tdev, _ = both_indexes(idx)
    rng = np.random.default_rng(9)
    genome = rng.integers(0, 4, 20000).astype(np.int8)
    r1, r2 = [], []
    for s in seqs:
        for _ in range(3):
            st = int(rng.integers(0, s.size - 300))
            r1.append(s[st:st + 150])
            r2.append(dna.revcomp(s[st + 150:st + 300]))
    for st in range(0, 6000, 300):
        r1.append(genome[st:st + 150])
        r2.append(dna.revcomp(genome[st + 150:st + 300]))
    r1.append(seqs[0][:150])
    r2.append(genome[9000:9150])
    m1, m2 = batch(r1, 192), batch(r2, 192)
    m1[rng.integers(0, len(r1), 20), rng.integers(0, 150, 20)] = 4     # Ns
    if kind == "pairs":
        got = TR.run_pairs(tdev, m1, m2, device="cpu")
        np.testing.assert_array_equal(got, JR.run_pairs(jdev, m1, m2))
        host = [recruit_read_pair(idx, m1[i], m2[i]) for i in range(len(r1))]
    else:
        got = TR.run_short(tdev, m1, device="cpu")
        np.testing.assert_array_equal(got, JR.run_short(jdev, m1))
        host = [recruit_short_read(idx, m1[i]) for i in range(len(r1))]
    assert [sorted(np.nonzero(g)[0].tolist()) for g in got] == host
    assert got.any() and not got.all()
    assert got[:, 32 * (tdev.n_groups - 1):].any()  # hits in the last word


def test_run_long_equals_reference_and_host(world):
    rng, genome, locus, cset, kc = world
    params = RecruitParams(match_frac=0.5, match_length=2000)
    idx = TargetIndex(params)
    idx.add_locus(cset, kc)
    idx.finalize()
    jdev, tdev, _ = both_indexes(idx)
    reads = sim.simulate_single_reads(
        rng, [locus.haplotypes[i] for i in locus.true_genotype],
        depth=2, read_len_mean=2800, read_len_sd=400)
    mix = reads.reads1[:20]
    # Background reads and chimeras (locus prefix + background tail —
    # exercises the stretch rule specifically).
    for _ in range(10):
        s = int(rng.integers(0, 10000))
        mix.append(genome[s:s + 3000])
    for _ in range(10):
        s = int(rng.integers(0, 10000))
        mix.append(np.concatenate([locus.haplotypes[0][200:1400],
                                   genome[s:s + 4000]]))
    L = -(-max(r.size for r in mix) // 256) * 256
    m = batch(mix, L)
    args = (params.stretch_minims, params.stretch_score)
    got = TR.run_long(tdev, m, *args, device="cpu")
    np.testing.assert_array_equal(got, JR.run_long(jdev, m, *args))
    n_hit = 0
    for i, r in enumerate(mix):
        host = recruit_long_read(idx, r)
        assert sorted(np.nonzero(got[i])[0].tolist()) == host, i
        n_hit += bool(host)
    assert 0 < n_hit < len(mix)
    # The exact width (no bucket) gives the same decisions.
    got2 = TR.run_long(tdev, batch(mix, max(r.size for r in mix)), *args,
                       device="cpu")
    np.testing.assert_array_equal(got2, got)


def test_empty_index_recruits_nothing():
    idx = TSR.TargetIndex(TSR.RecruitParams(match_frac=0.5))
    idx.n_loci = 1
    idx.finalize()
    tdev = TR.DeviceIndex.from_index(idx)
    assert tdev.keys.size == 0 and tdev.packed.shape == (0, 4)
    m = np.random.default_rng(0).integers(0, 4, (5, 160)).astype(np.int8)
    assert not TR.run_short(tdev, m, device="cpu").any()
    assert not TR.run_pairs(tdev, m, m, device="cpu").any()
    assert not TR.run_long(tdev, m, 364, 100, device="cpu").any()


def test_entries_default_to_cuda_and_raise_without_one(index):
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    _, tdev, _ = both_indexes(index)
    m = np.zeros((2, 160), np.int8)
    for call in (lambda: TR.run_short(tdev, m),
                 lambda: TR.run_pairs_async(tdev, m, m),
                 lambda: TR.run_long(tdev, m, 364, 100)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
