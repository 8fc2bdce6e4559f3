#!/usr/bin/env python3
"""Times the recruitment index's sorted-key lookup against a displacement
hash on one GPU.

    python3 time_index_lookup.py

The port looks minimizers up by a binary search over the sorted keys
(`ops/recruit.py:_lookup_rows`).  The JAX package, from 131,072 keys on
(its `HASH_MIN_KEYS`), looks them up instead in a Pagh hash-and-displace
table: two dependent gathers and no search.  This script keeps its own copy
of that table's build (`build_disp_hash`, numpy, on the host) and of its
lookup in plain PyTorch, in two forms: `hash64`, its unsigned 32-bit
products formed in int64 from 16-bit halves, and `hash32`, int32 products
left to wrap and shifts masked to logical ones.

Each case has random sorted keys (the top bit set in about half), packed
rows of the case's width, and queries of `chip_smoke.py`'s largest recruit
batch, [65,536, 80] in the signed view: half of them undefined hashes
(masked, as the front end's unused columns are), a share present in the
index, the rest absent.  The first two cases are sized as (f)'s 100-locus
panel index and (d)'s `preproc` region index; the third has 4,194,304 keys.
Both hash forms must find the same rows as the sorted search.  Then the
three are timed in turns (sorted, hash64, hash32, hash32, hash64, sorted;
`chip_smoke.time_ms` each: CUDA events, median of 5 warm calls), and the
table's build is timed on the host.  Prints the card's name and power limit
first.
"""
import subprocess
import sys
import time

import numpy as np
import torch

from chip_smoke import time_ms
from locityper_tpu_torch.ops import recruit as R

HC1, HC2, HC3 = 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D
B, S = 65536, 80                        # chip_smoke.py's largest batch
#: (label, keys, words a row, share of the queries present in the index)
CASES = [("(f) panel index", 159_094, 13, 0.29),
         ("(d) preproc region index", 828_863, 4, 0.15),
         ("4M keys", 1 << 22, 4, 0.15)]


def build_disp_hash(keys, packed):
    """(d_tab [Bk] uint32, shift_b, shift_t, table [T, W] uint32): every
    key in its own slot ((key ^ d*C3) * C2) >> shift_t, d = d_tab[(key*C1)
    >> shift_b]; buckets commit in rounds, the lowest bucket first on a
    contested slot.  Empty slots hold the key 0xFFFFFFFF."""
    M = keys.size
    T = 1 << max(int(np.ceil(np.log2(max(M, 2) * 2.0))), 4)
    Bk = 1 << max(int(np.ceil(np.log2(max(M, 2)))), 4)
    shift_b, shift_t = 32 - int(np.log2(Bk)), 32 - int(np.log2(T))
    c1, c2, c3 = (np.uint32(c) for c in (HC1, HC2, HC3))
    with np.errstate(over="ignore"):
        b = ((keys * c1) >> np.uint32(shift_b)).astype(np.int64)
        d_tab = np.zeros(Bk, np.uint32)
        taken = np.zeros(T, bool)
        slot_of = np.zeros(M, np.int64)
        unplaced = np.ones(M, bool)
        for _round in range(100_000):
            ki = np.nonzero(unplaced)[0]
            if ki.size == 0:
                break
            kb = b[ki]
            slots = (((keys[ki] ^ (d_tab[kb] * c3)) * c2)
                     >> np.uint32(shift_t)).astype(np.int64)
            order = np.lexsort((kb, slots))
            ss = slots[order]
            win_sorted = np.ones(ss.size, bool)
            win_sorted[1:] = ss[1:] != ss[:-1]
            win_sorted &= ~taken[ss]
            win = np.empty(ss.size, bool)
            win[order] = win_sorted
            bucket_ok = np.ones(Bk, bool)
            np.logical_and.at(bucket_ok, kb, win)
            commit = bucket_ok[kb]
            ci = ki[commit]
            taken[slots[commit]] = True
            slot_of[ci] = slots[commit]
            unplaced[ci] = False
            d_tab[np.unique(kb[~commit])] += np.uint32(1)
        else:
            raise RuntimeError("displacement hash build did not converge")
    table = np.zeros((T, packed.shape[1]), np.uint32)
    table[:, 0] = np.uint32(0xFFFFFFFF)
    table[slot_of] = packed
    return d_tab, shift_b, shift_t, table


def mul64(x, c):
    """(x * c) mod 2^32 for int64 x in [0, 2^32), from x's 16-bit halves."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & 0xFFFFFFFF


def hash64(h, mask, d_tab, table, shift_b, shift_t):
    h_u = h.reshape(-1).to(torch.int64) + R.SIGN_BIT
    b = mul64(h_u, HC1) >> shift_b
    d = d_tab[b].to(torch.int64) & 0xFFFFFFFF
    slot = mul64(h_u ^ mul64(d, HC3), HC2) >> shift_t
    rows = table[slot].reshape(h.shape + (table.shape[1],))
    return (rows[..., 0] == (h ^ R._I32_MIN)) & mask, rows


def signed(c):
    return c - (1 << 32) if c >= 1 << 31 else c


def hash32(h, mask, d_tab, table, shift_b, shift_t):
    h_u = h.reshape(-1) ^ R._I32_MIN
    b = ((h_u * signed(HC1)) >> shift_b) & ((1 << (32 - shift_b)) - 1)
    slot = (((h_u ^ (d_tab[b] * signed(HC3))) * signed(HC2)) >> shift_t) \
        & ((1 << (32 - shift_t)) - 1)
    rows = table[slot].reshape(h.shape + (table.shape[1],))
    return (rows[..., 0] == h_u.reshape(h.shape)) & mask, rows


def make_case(rng, M, W, present, device, b=B, s=S):
    """(keys, packed, h [b, s] int32 signed view, mask [b, s] bool)."""
    keys = np.unique(rng.integers(0, 1 << 32, int(M * 1.01) + 64,
                                  dtype=np.uint64).astype(np.uint32))
    keys = np.sort(rng.permutation(keys[keys != 0xFFFFFFFF])[:M])
    packed = rng.integers(0, 1 << 32, (M, W), dtype=np.uint64) \
        .astype(np.uint32)
    packed[:, 0] = keys
    u = rng.random((b, s))
    raw = rng.integers(0, 1 << 32, (b, s), dtype=np.uint64).astype(np.uint32)
    hit = u < present
    raw[hit] = keys[rng.integers(0, M, int(hit.sum()))]
    mask = u < 0.5 + present / 2
    raw[~mask] = 0xFFFFFFFF                      # the undefined hash
    h = (raw ^ np.uint32(R.SIGN_BIT)).view(np.int32)
    return keys, packed, torch.from_numpy(h).to(device), \
        torch.from_numpy(mask).to(device)


def on(a, device):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)


def run_case(label, M, W, present, device, b=B, s=S):
    rng = np.random.default_rng(M)
    keys, packed, h, mask = make_case(rng, M, W, present, device, b, s)
    t0 = time.perf_counter()
    d_tab, shift_b, shift_t, table = build_disp_hash(keys, packed)
    build_s = time.perf_counter() - t0
    cfg = R._Cfg(32 * ((W - 1) // 3), (W - 1) // 3, 15, 10, 0, 1)
    sorted_args = (on(keys ^ np.uint32(R.SIGN_BIT), device), on(packed, device))
    hash_args = (on(d_tab, device), on(table, device), shift_b, shift_t)
    forms = {"sorted": lambda: R._lookup_rows(cfg, h, mask, *sorted_args),
             "hash64": lambda: hash64(h, mask, *hash_args),
             "hash32": lambda: hash32(h, mask, *hash_args)}
    found, rows = forms["sorted"]()
    for name in ("hash64", "hash32"):
        f2, r2 = forms[name]()
        if not (torch.equal(found, f2) and torch.equal(rows[found], r2[f2])):
            raise SystemExit(f"{label}: {name} finds other rows than sorted")
    times = {name: [] for name in forms}
    if h.is_cuda:
        for name in ("sorted", "hash64", "hash32", "hash32", "hash64",
                     "sorted"):
            times[name].append(time_ms(forms[name]))
    print(f"{label}: {M} keys, rows of {W} words, queries {list(h.shape)}, "
          f"{int(found.sum())} found by all three; "
          + ", ".join(f"{n} " + (" / ".join(f"{t:.4f}" for t in ts) + " ms"
                                 if ts else "not measured")
                      for n, ts in times.items())
          + f"; hash table [{table.shape[0]}, {W}] + [{d_tab.size}] built "
          f"in {build_s:.2f} s on the host", flush=True)


def main():
    if not torch.cuda.is_available():
        print("time_index_lookup: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    for label, M, W, present in CASES:
        run_case(label, M, W, present, "cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
