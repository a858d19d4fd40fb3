"""The hand-written CUDA kernels against their plain PyTorch versions on
the card, at the main path's widths (L = 512). Every test here needs a
CUDA device and skips without one; on the card, run them with
`python -m pytest tests/test_torch_cuda.py -m cuda`."""

import numpy as np
import pytest
import torch

from acoss_tpu_torch.benchmarking.algorithms import (EarlyFusion, EarlySNF,
                                                     Serra09)
from acoss_tpu_torch.convert import descriptors_from_numpy
from acoss_tpu_torch.data import make_synthetic_dataset
from acoss_tpu_torch.ops import alignment, alignment_cuda, crp_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    # decided inside the test run, never while the module is imported
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _crps(seed, B=32, L=512, density=0.095):
    """The bench workload (ragged lengths 320..512 at L = 512) plus
    degenerate pairs: sides of 2, 3 and 4 and a zero length."""
    rng = np.random.default_rng(seed)
    m = rng.integers(L * 5 // 8, L + 1, B).astype(np.int32)
    n = rng.integers(L * 5 // 8, L + 1, B).astype(np.int32)
    m[:5] = [2, 3, 4, 0, L]
    n[:5] = [L, 3, 4, L // 2, 2]
    S = np.zeros((B, L, L), np.uint8)
    for b in range(B):
        S[b, :m[b], :n[b]] = rng.random((m[b], n[b])) < density
    return S, m, n


# wrapper, plain version and keyword arguments of each aligner kernel
ALIGNERS = {
    "qmax": ("qmax_batch_cuda", "qmax_batch_ref", {}),
    "dmax": ("dmax_batch_cuda", "dmax_batch_ref", {}),
    "qmax_uneq_03_08": ("qmax_uneq_batch_cuda", "qmax_uneq_batch_ref",
                        {"gap_onset": 0.3, "gap_extension": 0.8}),
    "qmax_uneq_08_03": ("qmax_uneq_batch_cuda", "qmax_uneq_batch_ref",
                        {"gap_onset": 0.8, "gap_extension": 0.3}),
    "sw": ("swconstrained_batch_cuda", "swconstrained_batch_ref", {}),
}


@pytest.mark.parametrize("L", [512, 576])
@pytest.mark.parametrize("name", list(ALIGNERS))
def test_aligner_kernel_bit_equal_to_plain(dev, name, L):
    """At the Serra09 (512) and EarlyFusion (576) widths, with degenerate
    pairs and a pair whose rows 0 and 1 are all matches."""
    S, m, n = (torch.from_numpy(a).to(dev) for a in _crps(0, L=L))
    S[5, :2, :n[5]] = 1
    wname, rname, kw = ALIGNERS[name]
    wrapper = getattr(alignment_cuda, wname)
    before = wrapper.launches
    got = wrapper(S, m, n, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    want = getattr(alignment_cuda, rname)(S, m, n, **kw)
    assert torch.equal(got, want)
    assert float(got[5:].min()) > 0


@pytest.mark.parametrize("d", [12, 13])
def test_fused_crp_kernel_bit_equal_to_plain(dev, d):
    rng = np.random.default_rng(d)
    B, L = 8, 512
    l1 = rng.integers(320, L + 1, B).astype(np.int32)
    l2 = rng.integers(320, L + 1, B).astype(np.int32)
    l1[:2] = [0, 12]          # zero length; round(0.095 * 4) == 0
    X = rng.standard_normal((B, L, d)).astype(np.float32)
    Y = rng.standard_normal((B, L, d)).astype(np.float32)
    args = [torch.from_numpy(a).to(dev) for a in (X, Y, l1, l2)]
    got = crp_cuda.fused_binary_crp_batch(*args, kappa=0.095, m=9)
    want = crp_cuda.fused_binary_crp_ref(*args, kappa=0.095, m=9)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[0][:2].sum()) == 0 and int(got[0][2:].sum()) > 0


def test_serra09_tile_kernel_path_equals_plain(dev):
    fs = make_synthetic_dataset(n_cliques=4, clique_size=2, seed=0,
                                base_duration=300.0, beat_period=30.0)
    algo = Serra09()
    d = descriptors_from_numpy(algo.extract_descriptors(fs, device=dev),
                               dev)
    got = algo.tile_scores(d, d)
    want = algo.tile_scores(d, d, plain=True)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_binarize_kernel_bit_equal_to_plain(dev):
    """Negative values, -0.0 next to +0.0 and ties (the negated SNF cross
    block), pairs whose rounded k is 0, a zero and a negative length."""
    rng = np.random.default_rng(20)
    B, L = 10, 512
    D = rng.standard_normal((B, L, L)).astype(np.float32)
    fused = rng.random((3, L, L)).astype(np.float32)
    fused[rng.random(fused.shape) < 0.3] = 0.0
    D[:3] = -fused
    D[1, :, ::5] = np.abs(D[1, :, ::5])
    D[2] = np.round(D[2] * 4) / 4
    l1 = rng.integers(300, L + 1, B).astype(np.int32)
    l2 = rng.integers(300, L + 1, B).astype(np.int32)
    l1[3:6], l2[6:8] = [5, 0, -3], [4, 0]
    D, l1, l2 = (torch.from_numpy(a).to(dev) for a in (D, l1, l2))
    before = crp_cuda.binarize_matrix_batch.launches
    got = crp_cuda.binarize_matrix_batch(D, l1, l2, 0.095)
    torch.cuda.synchronize()
    assert crp_cuda.binarize_matrix_batch.launches == before + 1
    want = crp_cuda.binarize_matrix_ref(D, l1, l2, 0.095)
    assert torch.equal(got, want)
    assert int(got[3:8].sum()) == 0 and int(got[:3].sum()) > 0


@pytest.mark.parametrize("largest", [True, False])
def test_knn_mask_kernel_bit_equal_to_plain(dev, largest):
    rng = np.random.default_rng(21)
    B, n = 6, 1024
    W = rng.random((B, n, n)).astype(np.float32)
    W[rng.random(W.shape) < 0.2] = 0.25          # ties at the threshold
    W[2, :100] = 0.0
    k = np.array([1, n, 99, 0, n + 5, 17], np.int32)
    W, k = torch.from_numpy(W).to(dev), torch.from_numpy(k).to(dev)
    got = crp_cuda.knn_mask_matrix_batch(W, k, largest)
    want = crp_cuda.knn_mask_matrix_ref(W, k, largest)
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))


def test_wcsmssm_kernel_value_equal_to_plain(dev):
    rng = np.random.default_rng(22)
    B, L = 4, 512
    A, Bm, C = rng.random((3, B, L, L)).astype(np.float32)
    l1 = np.array([512, 400, 12, 300], np.int32)
    l2 = np.array([512, 450, 15, 2], np.int32)
    K = (np.float32(0.095) * (l1 + l2).astype(np.float32)).astype(np.int32)
    K[0] = 1                                     # a tiny K
    args = [torch.from_numpy(a).to(dev) for a in (A, Bm, C, l1, l2, K)]
    got = crp_cuda.wcsmssm_batch(*args)
    want = crp_cuda.wcsmssm_ref(*args)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_early_snf_tile_kernel_path(dev, precision):
    """Parity mode: the kernel path equals its plain composition exactly
    (binarizer and mask are exact, the float work is shared). Throughput
    mode: the fused WCSMSSM kernel runs, once per channel."""
    fs = make_synthetic_dataset(n_cliques=2, clique_size=2, seed=0,
                                base_duration=300.0, beat_period=30.0)
    algo = EarlySNF(snf_precision=precision)
    d = descriptors_from_numpy(algo.extract_descriptors(fs, device=dev),
                               dev)
    before = crp_cuda.wcsmssm_batch.launches
    got = algo.tile_scores(d, d)
    torch.cuda.synchronize()
    fast = precision == "default"
    assert crp_cuda.wcsmssm_batch.launches == before + 2 * fast
    want = algo.tile_scores(d, d, plain=True)
    assert sorted(got) == sorted(algo.SIMILARITY_TYPES)
    for k in want:
        assert torch.isfinite(got[k]).all(), k
        if not fast:
            assert torch.equal(got[k], want[k]), k


def test_serra09_ssms_tile_kernel_path_equals_plain(dev):
    fs = make_synthetic_dataset(n_cliques=2, clique_size=2, seed=1,
                                base_duration=300.0, beat_period=30.0)
    algo = Serra09(do_ssms=True)
    d = descriptors_from_numpy(algo.extract_descriptors(fs, device=dev),
                               dev)
    before = crp_cuda.binarize_matrix_batch.launches
    got = algo.tile_scores(d, d)
    assert crp_cuda.binarize_matrix_batch.launches == before + 1
    want = algo.tile_scores(d, d, plain=True)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_early_fusion_tile_kernel_path_equals_plain(dev):
    """The tile's one SW call launches the kernel and gives the scores of
    the SW kernel's plain version."""
    fs = make_synthetic_dataset(n_cliques=2, clique_size=2, seed=0,
                                base_duration=300.0, beat_period=30.0)
    algo = EarlyFusion()
    d = descriptors_from_numpy(algo.extract_descriptors(fs, device=dev),
                               dev)
    before = alignment_cuda.swconstrained_batch_cuda.launches
    got = algo.tile_scores(d, d)
    torch.cuda.synchronize()
    assert alignment_cuda.swconstrained_batch_cuda.launches == before + 1
    want = algo.tile_scores(d, d, plain=True)
    for k in algo.SIMILARITY_TYPES:
        assert torch.equal(got[k], want[k]), k
        assert float(got[k].max()) > 0, k


# dispatcher, the wrapper it must launch (None: no kernel, the plain scan)
# and keyword arguments; inside and outside the JAX package's guards
DISPATCH = [
    ("swconstrained", "swconstrained_batch_cuda", {}),
    ("swconstrained", "swconstrained_batch_cuda",
     {"gap_opening": 0.2, "mismatch_score": 0.3}),
    ("qmax", "qmax_uneq_batch_cuda", {"gap_onset": 0.3,
                                      "gap_extension": 0.6}),
    ("qmax", "qmax_uneq_batch_cuda", {"gap_onset": -0.2,
                                      "gap_extension": 0.4}),
    ("qmax", "qmax_batch_cuda", {"gap_onset": -0.3, "gap_extension": -0.3}),
    ("dmax", "dmax_batch_cuda", {"gap_onset": 1.5, "gap_extension": 1.5}),
    ("dmax", "dmax_batch_cuda", {"gap_onset": -0.2, "gap_extension": -0.2}),
    ("dmax", None, {"gap_onset": 0.3, "gap_extension": 0.8}),
]


def test_aligner_dispatch_on_cuda(dev):
    """The dispatchers launch a kernel for every CUDA batch, inside the JAX
    package's guards and outside them, and give the plain scan's scores;
    only dmax with unequal gaps (no kernel) takes the plain scan. The
    single-pair functions go through the dispatchers."""
    S, m, n = (torch.from_numpy(a).to(dev) for a in _crps(1, B=8, L=64))
    S[5, :2, :n[5]] = 1
    wrappers = {w: getattr(alignment_cuda, w) for _, w, _ in DISPATCH if w}
    for fn, wname, kw in DISPATCH:
        before = {w: f.launches for w, f in wrappers.items()}
        got = getattr(alignment, f"{fn}_batch_best")(S, m, n, **kw)
        one = getattr(alignment, fn)(S[5], m[5], n[5], **kw)
        torch.cuda.synchronize()
        after = {w: f.launches for w, f in wrappers.items()}
        assert after == {w: before[w] + 2 * (w == wname) for w in before}, \
            (fn, kw)
        want = getattr(alignment, f"{fn}_batch")(S, m, n, **kw)
        assert torch.equal(got, want), (fn, kw)
        assert float(one) == float(want[5]), (fn, kw)
