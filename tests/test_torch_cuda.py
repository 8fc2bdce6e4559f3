"""The CUDA kernels against their plain PyTorch versions, on a card.

These tests need an NVIDIA GPU and `nvcc`; they skip on a machine without
one.  Run them there with `python -m pytest tests/test_torch_cuda.py -q`;
`python3 chip_smoke.py` makes the same comparisons at full size.
"""
import numpy as np
import pytest
import torch

from locityper_tpu_torch.ops import align as TA
from locityper_tpu_torch.ops import solver_chains as TC

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("band", [20, 48, 96, 128, 160, 192, 224, 256])
def test_align_kernel_equals_plain_version(card, band):
    """One band for each compiled variant (1..8 band cells a lane)."""
    rng = np.random.default_rng(band)
    N, L = 999, 192
    hap = rng.integers(0, 4, 20_000).astype(np.int8)
    start = rng.integers(band, hap.size - 2 * L, N)
    reads = hap[start[:, None] + np.arange(L)[None, :]].copy()
    reads[rng.random((N, L)) < 0.02] = 3
    lens = rng.integers(L // 2, L + 1, N).astype(np.int32)
    wins = hap[(start - band // 2)[:, None] + np.arange(L + band)[None, :]]
    sv = torch.tensor(TA.Scores.from_error_rates(0.002, 0.0002, 0.0002)
                      .astuple(), dtype=torch.float32, device=card)
    args = [torch.from_numpy(x).to(card) for x in (reads, lens, wins)]
    got = TA.align_banded(*args, sv, band)
    want = TA.align_batch_reference(*args, sv, band)
    for k in TA.ALIGN_RESULT_KEYS:
        assert torch.equal(got[k], want[k]), k


def test_anneal_kernel_equals_plain_version(card):
    g = torch.Generator(device=card).manual_seed(0)
    G, A, R, K, W, D = 5, 4, 30, 5, 20, 64
    C = G * A
    probs = -4 * torch.rand((G, R, K), generator=g, device=card)
    w = torch.randint(0, W, (C, R, K, 2), generator=g, device=card,
                      dtype=torch.int32)
    winpk = w[..., 0] | (w[..., 1] << 16)
    vcount = torch.randint(1, K + 1, (G, R), generator=g, device=card,
                           dtype=torch.int32)
    nontrivial = vcount > 1
    nt_ixs = torch.argsort((~nontrivial).to(torch.uint8), dim=1,
                           stable=True).to(torch.int32)
    ntc = nontrivial.sum(1).clamp_min(1).to(torch.int32)
    start_temp = torch.full((G,), 5.0, device=card)
    wtab = -torch.rand((C, W, D), generator=g, device=card)
    assgn0 = torch.zeros((C, R), dtype=torch.int32, device=card)
    depth0 = torch.zeros((C, W), dtype=torch.int32, device=card)
    ones = torch.ones((C, R), dtype=torch.int32, device=card)
    depth0.scatter_add_(1, (winpk[:, :, 0] & 0xFFFF).long(), ones)
    depth0.scatter_add_(1, (winpk[:, :, 0] >> 16).long(), ones)
    cache0 = torch.gather(wtab, 2, depth0.clamp(0, D - 1).long()[..., None])[..., 0]
    args = (probs, winpk, vcount, nt_ixs, ntc, start_temp, wtab, assgn0,
            depth0, cache0)
    kw = dict(attempts=A, n_steps=1500, anneal_steps=0, dc=1.85, ac=0.15,
              plato=200, seed=7)
    for a, b in zip(TC.anneal_chains(*args, **kw),
                    TC.anneal_chains_reference(*args, **kw)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("B,L", [(1, 15), (257, 152), (4096, 192),
                                 (64, 16384)])
def test_minimizer_front_kernel_equals_plain_version(card, B, L):
    """Both entries of minimizer_front.cu, bit-identical on every output:
    reads with N, a row of one repeated base (every hash ties), a run of N,
    a truncating S, rows that span many tiles."""
    from locityper_tpu_torch.ops import recruit as TR
    rng = np.random.default_rng(B + L)
    reads = rng.integers(0, 4, (B, L)).astype(np.int8)
    reads[rng.random((B, L)) < 0.01] = 4
    reads[B // 2] = 3
    reads[B // 3, L // 4:L // 2] = 4
    reads = torch.from_numpy(reads).to(card)
    k, w = 15, 10
    got = TR.minimizer_front(reads, k, w)
    want = TR.minimizer_front_reference(reads, k, w)
    for name, a, b in zip(("hs", "is_fw", "mask"), got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    P = L - k + 1
    for S in (TR._front_S(P, w), max(P // 16, 1), P + 5):
        got = TR.minimizer_front(reads, k, w, S)
        want = TR.minimizer_front_reference(reads, k, w, S)
        for name, a, b in zip(("hs", "is_fw", "mask", "total"), got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), (name, S)
    for k2, w2 in ((11, 5), (7, 1), (15, 40)):
        if L < k2:
            continue
        for S in (None, 12):
            got = TR.minimizer_front(reads, k2, w2, S)
            want = TR.minimizer_front_reference(reads, k2, w2, S)
            for a, b in zip(got, want):
                assert torch.equal(a, b), (k2, w2, S)
