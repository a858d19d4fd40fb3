"""The hand-written CUDA kernels against their plain PyTorch versions on
the card, at the main path's widths (L = 512). Every test here needs a
CUDA device and skips without one; on the card, run them with
`python -m pytest tests/test_torch_cuda.py -m cuda`."""

import numpy as np
import pytest
import torch

from acoss_tpu_torch.benchmarking.algorithms import Serra09
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


@pytest.mark.parametrize("name", ["qmax", "dmax"])
def test_aligner_kernel_bit_equal_to_plain(dev, name):
    S, m, n = (torch.from_numpy(a).to(dev) for a in _crps(0))
    wrapper = getattr(alignment_cuda, f"{name}_batch_cuda")
    before = wrapper.launches
    got = wrapper(S, m, n)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    want = getattr(alignment_cuda, f"{name}_batch_ref")(S, m, n)
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


def test_unported_kernels_raise_on_cuda(dev):
    S, m, n = (torch.from_numpy(a).to(dev) for a in _crps(1, B=8, L=64))
    with pytest.raises(NotImplementedError, match="Queue B"):
        alignment.swconstrained_batch_best(S, m, n)
    with pytest.raises(NotImplementedError, match="Queue B"):
        alignment.qmax_batch_best(S, m, n, gap_onset=0.3, gap_extension=0.6)
