"""The hand-written CUDA kernels against their plain PyTorch versions on
the card, at the main path's widths (L = 512). Every test here needs a
CUDA device and skips without one; on the card, run them with
`python -m pytest tests/test_torch_cuda.py -m cuda`."""

from tests import _torch_threads  # noqa: F401  (caps thread pools)

import numpy as np
import pytest
import torch

from acoss_tpu_torch.benchmarking.algorithms import (ANFScattering,
                                                     ChenFusion, EarlyFusion,
                                                     EarlySNF, FTM2D, Serra09,
                                                     Simple, TGAlg)
from acoss_tpu_torch.convert import descriptors_from_numpy
from acoss_tpu_torch.data import make_synthetic_dataset
from acoss_tpu_torch.ops import (alignment, alignment_cuda, crp_cuda,
                                 serra09_cuda)

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


@pytest.mark.parametrize("L", [100, 103, 512, 576, 1024])
@pytest.mark.parametrize("name", list(ALIGNERS))
def test_aligner_kernel_bit_equal_to_plain(dev, name, L):
    """At the Serra09 (512) and EarlyFusion (576) widths, at 100 (a row
    that is not a whole number of the 16-byte copies or 4-column runs of
    a warp), 103 (rows that are not 4-byte aligned in the stages: the
    byte-funnel reads of every register kernel; for SW and unequal-gap
    qmax also those of the 2 bytes left of a run) and 1024 (chunks of CRP
    rows that wrap the stage ring more often), with degenerate pairs and
    a pair whose rows 0 and 1 are all matches."""
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


# the keyword arguments each aligner kernel is held to plain with on rows
# past the 4-column runs: its own, and gaps or scores of the other sign
WIDE_PARAMS = {
    "qmax": [{"gap": 0.5}, {"gap": -0.3}],
    "dmax": [{"gap": 0.5}, {"gap": -0.3}],
    "qmax_uneq_03_08": [ALIGNERS["qmax_uneq_03_08"][2],
                        {"gap_onset": -0.2, "gap_extension": 0.5}],
    "qmax_uneq_08_03": [ALIGNERS["qmax_uneq_08_03"][2],
                        {"gap_onset": 0.5, "gap_extension": -0.2}],
    "sw": [{}, {"gap_opening": 0.2}],
}


def _wide_crps(seed, B, M, N):
    """Random CRPs of ragged lengths, a full-size pair and a side of 2."""
    rng = np.random.default_rng(seed)
    m = rng.integers(M * 5 // 8, M + 1, B).astype(np.int32)
    n = rng.integers(N * 5 // 8, N + 1, B).astype(np.int32)
    m[:2], n[:2] = [M, 2], [N, N]
    S = (rng.random((B, M, N)) < 0.095).astype(np.uint8)
    return S, m, n


def _check_wide(dev, name, S, m, n):
    S, m, n = (torch.from_numpy(a).to(dev) for a in (S, m, n))
    wname, rname, _ = ALIGNERS[name]
    for kw in WIDE_PARAMS[name]:
        got = getattr(alignment_cuda, wname)(S, m, n, **kw)
        want = getattr(alignment_cuda, rname)(S, m, n, **kw)
        assert torch.equal(got, want), kw
        assert float(got[0]) > 0 and float(got[1]) == 0, kw


@pytest.mark.parametrize("N", [2304, 2101])
@pytest.mark.parametrize("name", list(ALIGNERS))
def test_register_aligner_wide_rows_bit_equal_to_plain(dev, name, N):
    """Rows past 2048 columns, where the register kernels take 8 columns
    a thread (288 and 263 threads), aligned and not; gaps (and SW's
    opening) of the other sign."""
    _check_wide(dev, name, *_wide_crps(N, 6, 160, N))


@pytest.mark.parametrize("name", ["qmax_uneq_03_08", "qmax_uneq_08_03",
                                  "sw"])
def test_aligner_long_rows_take_shared_memory_kernel(dev, name):
    """Rows past `REGISTER_MAX_N` (16,400 columns): unequal-gap qmax and
    SW take the shared-memory kernels, bit-equal to plain."""
    N = 16400
    assert alignment_cuda.REGISTER_MAX_N < N <= alignment_cuda.SMEM_MAX_N
    _check_wide(dev, name, *_wide_crps(7, 2, 40, N))


@pytest.mark.parametrize("name", list(ALIGNERS))
def test_aligner_rows_past_limit_raise(dev, name):
    """A row longer than any kernel of the aligner takes is refused, not
    computed by the plain version."""
    wname, _, kw = ALIGNERS[name]
    limit = (alignment_cuda.REGISTER_MAX_N if name in ("qmax", "dmax")
             else alignment_cuda.SMEM_MAX_N)
    S = torch.zeros((1, 3, limit + 1), dtype=torch.uint8, device=dev)
    ln = torch.tensor([3], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match=f"N <= {limit}"):
        getattr(alignment_cuda, wname)(S, ln, ln, **kw)


# line widths of the fused CRP: the one-launch kernel on one block (100,
# 200; 100 is no multiple of 16: byte stores), on a cluster of 2 (256) and
# of 8 (512), and the two launches past 512 (520, 1024: 32 keys a lane)
FUSED_WIDTHS = [100, 200, 256, 512, 520, 1024]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("L", FUSED_WIDTHS)
@pytest.mark.parametrize("d", [12, 13])
def test_fused_crp_kernel_bit_equal_to_plain(dev, d, L, ties):
    """Lengths that are not multiples of 32 (a lane's last keys, a slab,
    a strip cut short), and a tie-heavy input: features on an integer
    grid, so that many windowed sums tie at the k-th value."""
    rng = np.random.default_rng(d + L + ties)
    B = 8
    l1 = rng.integers(L * 5 // 8, L + 1, B).astype(np.int32)
    l2 = rng.integers(L * 5 // 8, L + 1, B).astype(np.int32)
    l1[:2] = [0, 12]          # zero length; round(0.095 * 4) == 0
    l1[2], l2[2] = L - 1, L - 7
    X = rng.standard_normal((B, L, d)).astype(np.float32)
    Y = rng.standard_normal((B, L, d)).astype(np.float32)
    if ties:
        X, Y = np.round(X), np.round(Y)
    args = [torch.from_numpy(a).to(dev) for a in (X, Y, l1, l2)]
    got = crp_cuda.fused_binary_crp_batch(*args, kappa=0.095, m=9)
    want = crp_cuda.fused_binary_crp_ref(*args, kappa=0.095, m=9)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[0][:2].sum()) == 0 and int(got[0][2:].sum()) > 0


@pytest.mark.parametrize("L", [200, 512, 1024])
@pytest.mark.parametrize("d,m", [(7, 3), (16, 12)])
def test_fused_crp_kernel_other_widths_bit_equal_to_plain(dev, d, m, L):
    """Feature widths and windows other than Serra09's, which no kernel
    has compiled in: the one launch up to 512, the two past it."""
    rng = np.random.default_rng(d + m + L)
    B = 6
    l1 = rng.integers(L // 2, L + 1, B).astype(np.int32)
    l2 = rng.integers(L // 2, L + 1, B).astype(np.int32)
    l1[0], l2[1] = 0, L
    X = rng.standard_normal((B, L, d)).astype(np.float32)
    Y = rng.standard_normal((B, L, d)).astype(np.float32)
    args = [torch.from_numpy(a).to(dev) for a in (X, Y, l1, l2)]
    got = crp_cuda.fused_binary_crp_batch(*args, kappa=0.095, m=m)
    want = crp_cuda.fused_binary_crp_ref(*args, kappa=0.095, m=m)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[0][0].sum()) == 0 and int(got[0][1:].sum()) > 0


def test_fused_crp_kernel_batch_of_240_bit_equal_to_plain(dev):
    """A mesh call's batch at L = 512 (one cluster a pair): zero lengths,
    pairs whose rounded k is 0 on either side, full-length pairs and
    ragged ones, each kind spread over the batch."""
    rng = np.random.default_rng(240)
    B, L, d = 240, 512, 13
    l1 = rng.integers(1, L + 1, B).astype(np.int32)
    l2 = rng.integers(1, L + 1, B).astype(np.int32)
    l1[::12], l2[5::12] = 0, 0             # zero lengths
    l1[1::12], l2[2::12] = 12, 13          # round(0.095 * 4 or 5) == 0
    l1[3::12] = l2[3::12] = L              # full length
    l1[4::12], l2[4::12] = L, 9            # l2e == 1: k rounds to 0
    X = rng.standard_normal((B, L, d)).astype(np.float32)
    Y = rng.standard_normal((B, L, d)).astype(np.float32)
    args = [torch.from_numpy(a).to(dev) for a in (X, Y, l1, l2)]
    got = crp_cuda.fused_binary_crp_batch(*args, kappa=0.095, m=9)
    want = crp_cuda.fused_binary_crp_ref(*args, kappa=0.095, m=9)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    zero = torch.from_numpy((l1 < 14) | (l2 < 14)).to(dev)
    per_pair = got[0].sum((1, 2))
    assert int(per_pair[zero].sum()) == 0 and bool((per_pair[~zero] > 0).all())


def test_fused_crp_cluster_launches_by_width(dev):
    """The shape alone picks the design: a cluster of 8 at L = 512, which
    the wrapper counts in `cluster_launches` and the `crp:cluster_calls`
    counter, and the two launches at 1024, which it does not; `launches`
    counts every call."""
    from acoss_tpu_torch.utils.profiling import stages

    assert [crp_cuda.fused_crp_cluster(L, 12, 9)
            for L in FUSED_WIDTHS] == [1, 1, 2, 8, 0, 0]
    fn = crp_cuda.fused_binary_crp_batch
    was = stages.enabled
    stages.enabled = True
    try:
        for L, more in ((512, 1), (1024, 0)):
            X = torch.rand((2, L, 12), device=dev)
            n = torch.tensor([L, L - 40], dtype=torch.int32, device=dev)
            before = (fn.launches, fn.cluster_launches,
                      stages.counters["crp:cluster_calls"])
            fn(X, X, n, n)
            torch.cuda.synchronize()
            assert (fn.launches, fn.cluster_launches,
                    stages.counters["crp:cluster_calls"]) == (
                before[0] + 1, before[1] + more, before[2] + more), L
    finally:
        stages.enabled = was


@pytest.mark.parametrize("L", [512, 1024])
def test_fused_crp_writes_the_effective_lengths(dev, L):
    """Both designs (the cluster kernel at 512, the two launches at 1024)
    write l1e = max(l1 - m + 1, 0) and l2e likewise, the wrapper launching
    nothing else; a second call with other lengths reads its own."""
    X = torch.rand((6, L, 13), device=dev)
    fn = crp_cuda.fused_binary_crp_batch
    for lens in ([0, 5, 9, 10, L - 3, L], [L, 1, 0, 17, 8, 300]):
        l1 = torch.tensor(lens, dtype=torch.int32, device=dev)
        l2 = l1.flip(0).contiguous()
        before = fn.launches
        _, l1e, l2e = fn(X, X, l1, l2)
        assert fn.launches == before + 1
        assert l1e.dtype == l2e.dtype == torch.int32
        assert torch.equal(l1e, torch.clamp_min(l1 - 8, 0))
        assert torch.equal(l2e, torch.clamp_min(l2 - 8, 0))


def _tile_desc(seed: int, bi: int, bj: int, L: int, dev):
    """Random row and column descriptors of a Serra09 tile on the card:
    ragged lengths, among them 0 (a padding song, as on the mesh's card 0)
    and lengths below the window m = 9; MFCCs with a large leading term,
    as HTK energy."""
    g = torch.Generator().manual_seed(seed)
    n = bi + bj
    length = torch.randint(L * 5 // 8, L + 1, (n,), generator=g)
    length[::7] = 0
    length[3::7] = 5
    length[5::7] = L
    f = {"chroma": torch.rand((n, L, 12), generator=g),
         "mfcc": torch.randn((n, L, 13), generator=g),
         "gchroma": torch.rand((n, 12), generator=g),
         "length": length.to(torch.int32)}
    f["mfcc"][..., 0] += 3000.0
    f = {k: v.to(dev) for k, v in f.items()}
    return ({k: v[:bi] for k, v in f.items()},
            {k: v[bi:] for k, v in f.items()})


@pytest.mark.parametrize("bi,bj,L,oti", [
    (16, 16, 512, True), (240, 8, 512, True), (4, 6, 64, True),
    (1, 8, 320, True), (8, 1, 576, True), (3, 5, 512, False)])
def test_pair_operands_kernel_bit_equal_to_plain(dev, bi, bj, L, oti):
    """The prep kernel gives the torch composition's operands and lengths
    bit for bit: bi != bj, a query row (bi = 1), L 64 / 320 / 512 / 576,
    zero and sub-window lengths, with and without the OTI roll; one launch,
    counted in `score:prep_calls`."""
    from acoss_tpu_torch.utils.profiling import stages

    row, col = _tile_desc(bi * bj + L, bi, bj, L, dev)
    shift = Serra09()._oti(row, col) if oti else None
    args = (row["chroma"], col["chroma"], row["mfcc"], col["mfcc"],
            row["length"], col["length"], shift)
    fn = serra09_cuda.pair_operands_batch
    was = stages.enabled
    stages.enabled = True
    try:
        before = (fn.launches, stages.counters["score:prep_calls"])
        got = fn(*args)
        torch.cuda.synchronize()
        assert (fn.launches, stages.counters["score:prep_calls"]) == (
            before[0] + 1, before[1] + 1)
    finally:
        stages.enabled = was
    want = serra09_cuda.pair_operands_ref(*args)
    for g, w in zip(got, want):
        assert g.is_contiguous() and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("nf,B", [(2, 256), (3, 1920), (1, 1), (4, 300)])
def test_scores_epilogue_kernel_bit_equal_to_plain(dev, nf, B):
    """The epilogue kernel divides as torch does, bit for bit, pairs with
    l1e + l2e == 0 included; one launch."""
    g = torch.Generator().manual_seed(nf * B)
    q = [(torch.rand(B, generator=g) * 300).floor().to(dev) / 2
         for _ in range(nf)]
    d = [torch.rand(B, generator=g).to(dev) * 500 for _ in range(nf)]
    l1e = torch.randint(0, 505, (B,), generator=g, dtype=torch.int32)
    l2e = torch.randint(0, 505, (B,), generator=g, dtype=torch.int32)
    l1e[::5] = 0
    l2e[::10] = 0
    l1e, l2e = l1e.to(dev), l2e.to(dev)
    fn = serra09_cuda.scores_epilogue_batch
    before = fn.launches
    got = fn(q, d, l1e, l2e)
    assert fn.launches == before + 1 and got.shape == (2, nf, B)
    assert torch.equal(got, serra09_cuda.scores_epilogue_ref(q, d, l1e, l2e))


def _serra09_tile(dev, tile: str):
    """(algorithm, row, col) of a Serra09 tile: the 8 songs of a
    synthetic corpus against themselves (with the ssms channel for
    "corpus_ssms"), or random descriptors at a stream tile's 16 x 16 and
    a mesh call's 240 x 8."""
    if tile.startswith("corpus"):
        ssms = tile == "corpus_ssms"
        fs = make_synthetic_dataset(n_cliques=2 if ssms else 4,
                                    clique_size=2, seed=int(ssms),
                                    base_duration=300.0, beat_period=30.0)
        algo = Serra09(do_ssms=ssms)
        d = descriptors_from_numpy(algo.extract_descriptors(fs, device=dev),
                                   dev)
        return algo, d, d
    bi, bj = map(int, tile.split("x"))
    return (Serra09(), *_tile_desc(bi + bj, bi, bj, 512, dev))


@pytest.mark.parametrize("tile", ["corpus", "16x16", "240x8",
                                  "corpus_ssms"])
def test_serra09_tile_kernel_path_equals_plain(dev, tile):
    """The kernel path (prep, the fused CRP a channel, qmax and dmax on
    each channel's CRPs, the epilogue; the binarizer for ssms) gives the
    plain composition's scores bit for bit, with the launches that says."""
    algo, row, col = _serra09_tile(dev, tile)
    nf = len(algo._channels())
    wrappers = (serra09_cuda.pair_operands_batch,
                crp_cuda.fused_binary_crp_batch,
                crp_cuda.binarize_matrix_batch,
                alignment_cuda.qmax_batch_cuda,
                alignment_cuda.dmax_batch_cuda,
                serra09_cuda.scores_epilogue_batch)
    before = [w.launches for w in wrappers]
    got = algo.tile_scores(row, col)
    assert [w.launches - b for w, b in zip(wrappers, before)] == \
        [1, 2, nf - 2, nf, nf, 1]
    want = algo.tile_scores(row, col, plain=True)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert float(want["chroma_qmax"].max()) > 0


#: Kernels a Serra09 tile call launches on the card: the OTI's eight
#: torch kernels (`crp.get_oti`: the shift index's arange, subtraction and
#: remainder, the circulant gather, matmul's two broadcast copies, the
#: product, the argmax), the prep, the fused CRP twice, qmax and dmax
#: twice, the epilogue.
SERRA09_TILE_LAUNCHES = 16


def test_serra09_tile_launches_under_the_profiler(dev):
    """A warm 16 x 16 tile call launches at most SERRA09_TILE_LAUNCHES
    kernels, counted by the profiler (copies and memsets aside)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    algo, row, col = _serra09_tile(dev, "16x16")
    algo.tile_scores(row, col)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        algo.tile_scores(row, col)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and not e.name.startswith(("Memcpy", "Memset"))]
    assert 0 < len(names) <= SERRA09_TILE_LAUNCHES, "\n".join(
        n[:80] for n in names)


# line widths of the binarizer and kNN mask tests: a lane's last keys cut
# short (100), an odd width (103: the binarizer's scalar loads and byte
# stores),
# the EarlySNF widths (512, 1024), 64 and 192 keys a lane (2001, 6144),
# and past the register range (6200: a block a line)
SELECT_WIDTHS = [100, 103, 512, 1024, 2001, 6144, 6200]


@pytest.mark.parametrize("L", SELECT_WIDTHS)
def test_binarize_kernel_bit_equal_to_plain(dev, L):
    """Negative values, -0.0 next to +0.0 and ties (the negated SNF cross
    block), pairs whose rounded k is 0, a zero and a negative length; two
    more pairs whose rows or columns keep k = 1 (length 11)."""
    rng = np.random.default_rng(20 if L == 512 else 20 + L)
    B = 10
    D = rng.standard_normal((B, L, L)).astype(np.float32)
    fused = rng.random((3, L, L)).astype(np.float32)
    fused[rng.random(fused.shape) < 0.3] = 0.0
    D[:3] = -fused
    D[1, :, ::5] = np.abs(D[1, :, ::5])
    D[2] = np.round(D[2] * 4) / 4
    l1 = rng.integers(L * 300 // 512, L + 1, B).astype(np.int32)
    l2 = rng.integers(L * 300 // 512, L + 1, B).astype(np.int32)
    l1[3:6], l2[6:8] = [5, 0, -3], [4, 0]
    D = np.concatenate([D, rng.standard_normal((2, L, L)).astype(np.float32)])
    l1 = np.concatenate([l1, [L, 11]]).astype(np.int32)
    l2 = np.concatenate([l2, [11, L]]).astype(np.int32)
    D, l1, l2 = (torch.from_numpy(a).to(dev) for a in (D, l1, l2))
    before = crp_cuda.binarize_matrix_batch.launches
    got = crp_cuda.binarize_matrix_batch(D, l1, l2, 0.095)
    torch.cuda.synchronize()
    assert crp_cuda.binarize_matrix_batch.launches == before + 1
    want = crp_cuda.binarize_matrix_ref(D, l1, l2, 0.095)
    assert torch.equal(got, want)
    assert int(got[3:8].sum()) == 0 and int(got[:3].sum()) > 0
    assert int(got[10:].sum()) > 0


@pytest.mark.parametrize("n", SELECT_WIDTHS)
@pytest.mark.parametrize("largest", [True, False])
def test_knn_mask_kernel_bit_equal_to_plain(dev, largest, n):
    """k = 1, n, 99, 0 (clamped to 1), n + 5 (clamped to n) and 17, with
    ties at the threshold and rows of zeros; then k = 48, 64, 65, 95 and
    128, around the lanes' one, two and four smallest keys that bracket
    the search, with -0.0 next to +0.0."""
    rng = np.random.default_rng(21 if n == 1024 else 21 + n)
    B = 6
    W = rng.random((B, n, n)).astype(np.float32)
    W[rng.random(W.shape) < 0.2] = 0.25          # ties at the threshold
    W[2, :100] = 0.0
    k = np.array([1, n, 99, 0, n + 5, 17], np.int32)
    more = rng.random((5, n, n)).astype(np.float32)
    more[rng.random(more.shape) < 0.1] = 0.5
    more[0, :, ::3] = 0.0
    more[0, :, 1::3] = -0.0
    more[1] = -more[1]
    W = np.concatenate([W, more])
    k = np.concatenate([k, [48, 64, 65, 95, 128]]).astype(np.int32)
    W, k = torch.from_numpy(W).to(dev), torch.from_numpy(k).to(dev)
    before = crp_cuda.knn_mask_matrix_batch.launches
    got = crp_cuda.knn_mask_matrix_batch(W, k, largest)
    torch.cuda.synchronize()
    assert crp_cuda.knn_mask_matrix_batch.launches == before + 1
    want = crp_cuda.knn_mask_matrix_ref(W, k, largest)
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))


@pytest.mark.parametrize("L,ties", [(100, False), (512, False),
                                    (1024, False), (512, True)])
def test_wcsmssm_kernel_value_equal_to_plain(dev, L, ties):
    """Within rtol 2e-5 / atol 2e-6 of plain at L = 100 (tiles and lines
    cut short), 512 and 1024 (32 keys a lane), and on integer-valued
    SSMs and CSM (many values tie at the k-th); K = 1 and K = 0, a zero
    length, a length of 1, l1 != l2. W_SSMA and W_SSMB are symmetric and
    the lower-left quadrant is the upper-right's transpose, bit for bit."""
    rng = np.random.default_rng(22 + L + ties)
    B = 6
    A, Bm, C = rng.random((3, B, L, L)).astype(np.float32)
    if ties:
        A, Bm, C = (np.floor(x * 8) for x in (A, Bm, C))
    l1 = rng.integers(L * 5 // 8, L + 1, B).astype(np.int32)
    l2 = rng.integers(L * 5 // 8, L + 1, B).astype(np.int32)
    l1[:4], l2[:4] = [L, 0, 1, L - 3], [L, L // 2, L - 1, 2]
    K = (np.float32(0.095) * (l1 + l2).astype(np.float32)).astype(np.int32)
    K[0], K[4] = 1, 0
    args = [torch.from_numpy(a).to(dev) for a in (A, Bm, C, l1, l2, K)]
    before = crp_cuda.wcsmssm_batch.launches
    got = crp_cuda.wcsmssm_batch(*args)
    torch.cuda.synchronize()
    assert crp_cuda.wcsmssm_batch.launches == before + 1
    want = crp_cuda.wcsmssm_ref(*args)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-6)
    WA, WB = got[:, :L, :L], got[:, L:, L:]
    assert torch.equal(WA, WA.transpose(1, 2))
    assert torch.equal(WB, WB.transpose(1, 2))
    assert torch.equal(got[:, L:, :L], got[:, :L, L:].transpose(1, 2))


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


@pytest.mark.parametrize("engine", ["streamed", "bucketed", "hybrid"])
def test_sweep_engine_on_the_card_equals_plain_sweep(dev, tmp_path, engine):
    """Serra09 over an int8 store of Da-TACOS-length songs: every tile an
    engine scores is on the card, and its scores equal the plain in-RAM
    sweep of the same dequantized descriptors in the same song order (the
    length-sorted one for the bucketed sweep) bit for bit."""
    from acoss_tpu_torch.benchmarking import harness
    from acoss_tpu_torch.data import LazySyntheticCorpus
    from acoss_tpu_torch.data.descstore import (DescriptorStore,
                                                extract_streamed,
                                                upcast_stream)

    corpus = LazySyntheticCorpus(n_cliques=3, clique_size=3,
                                 n_distractors=7)
    n = corpus.n_songs

    class OnCard(Serra09):
        def tile_scores(self, row, col, plain=False):
            assert all(v.is_cuda for v in (*row.values(), *col.values()))
            return super().tile_scores(row, col, plain)

    def dequantized(d):
        return upcast_stream({k: torch.from_numpy(np.array(v))
                              for k, v in d.items()})

    before = alignment_cuda.qmax_batch_cuda.launches
    if engine == "bucketed":
        sd = str(tmp_path / "stream")
        got, perm = harness.run_pairwise_bucketed(
            OnCard(), corpus.subset(np.arange(n)), n_buckets=2,
            stream_dir=sd, stream_quant="int8", stream_min_bytes=16384,
            return_perm=True, device=dev)
        desc = harness._merge_bucket_descs(
            [dequantized(DescriptorStore.open(f"{sd}/desc/bucket_{b:04d}"))
             for b in range(2)], np.arange(n))
    else:
        store = extract_streamed(Serra09(), corpus, str(tmp_path / "store"),
                                 quant="int8", half_min_bytes=16384,
                                 device=dev)
        assert store["chroma"].dtype == np.int8
        got = (harness.run_pairwise_hybrid(OnCard(), store, n,
                                           panel_songs=8, device=dev)
               if engine == "hybrid" else
               harness.run_pairwise(OnCard(), store, n, device=dev,
                                    device_resident=False))
        desc = dequantized(store)
    torch.cuda.synchronize()
    assert alignment_cuda.qmax_batch_cuda.launches - before == 2 * 3
    want = harness.run_pairwise(Serra09(), desc, n, device=dev)
    for k in want:
        assert np.array_equal(np.asarray(got[k]), want[k]), k


def _serra09_int8_store(dev, path, **corpus):
    from acoss_tpu_torch.data import LazySyntheticCorpus
    from acoss_tpu_torch.data.descstore import extract_streamed

    corpus = LazySyntheticCorpus(**corpus)
    store = extract_streamed(Serra09(), corpus, str(path), quant="int8",
                             half_min_bytes=16384, device=dev)
    assert sorted(store) == ["chroma", "chroma@qscale", "gchroma", "length",
                             "mfcc", "mfcc@qscale"]
    return store, corpus.n_songs


def test_upload_is_six_copies_a_tile_staged_sweep_one_a_fetch(dev,
                                                              tmp_path):
    """A column tile of Serra09's int8 store uploaded directly
    (`_upload(_tile_slice(...))`, the bucketed and hybrid sweeps' path)
    reaches the card in six copies (chroma, mfcc, their `@qscale`
    companions, gchroma, length), as `store:h2d_copies` counts them; the
    streamed `run_pairwise` stages each fetch and makes one copy a
    `sweep:tile` and one a `sweep:row`, of the same bytes."""
    from acoss_tpu_torch.benchmarking import harness
    from acoss_tpu_torch.utils.profiling import stages

    store, n = _serra09_int8_store(dev, tmp_path / "store", n_cliques=2,
                                   clique_size=3, n_distractors=3)
    stages.reset()
    stages.enabled = True
    try:
        cols = harness._tile_slice(store, 4, 8, 4)
        harness._upload(cols, dev)
        assert stages.counters["store:h2d_copies"] == 6
        tile_bytes = sum(v.nbytes for v in cols.values())
        assert stages.counters["store:h2d_bytes"] == tile_bytes
        stages.reset()
        harness.run_pairwise(Serra09(), store, n, tile=4, device=dev,
                             device_resident=False)
        torch.cuda.synchronize()
        fetches = stages.count["sweep:tile"] + stages.count["sweep:row"]
        assert fetches == 6 + 3
        assert stages.counters["store:h2d_copies"] == fetches
        assert stages.counters["store:h2d_bytes"] == fetches * tile_bytes
        assert "store:stage_waits" in stages.counters
    finally:
        stages.enabled = False
        stages.reset()


@pytest.mark.parametrize("held_back", [False, True],
                         ids=["free", "device-held-back"])
def test_staged_sweep_bit_equal_to_upload_sweep(dev, tmp_path, monkeypatch,
                                                held_back):
    """The streamed sweep on the staged path (pinned slabs, one
    non-blocking copy a fetch) gives the score matrices of the same sweep
    forced through `_upload(_tile_slice(...))`, bit for bit; also when
    every tile's kernels wait behind a device sleep, so the host fills
    the slab ring and has to wait for a slab's copy (`store:stage_waits`
    > 0) before reusing it."""
    from acoss_tpu_torch.benchmarking import harness
    from acoss_tpu_torch.utils.profiling import stages

    store, n = _serra09_int8_store(dev, tmp_path / "store", n_cliques=3,
                                   clique_size=3, n_distractors=7)

    class HeldBack(Serra09):
        def tile_scores(self, row, col, plain=False):
            if held_back:
                torch.cuda._sleep(50_000_000)      # ~25 ms of the card
            return super().tile_scores(row, col, plain)

    # the kernels built first, so the sweep's host work a tile is short
    harness.run_pairwise(Serra09(), store, n, tile=4, device=dev,
                         device_resident=False,
                         tile_filter=lambda ti, tj: (ti, tj) == (1, 0))
    stages.reset()
    stages.enabled = True
    try:
        got = harness.run_pairwise(HeldBack(), store, n, tile=4, device=dev,
                                   device_resident=False)
        torch.cuda.synchronize()
        waits = stages.counters["store:stage_waits"]
        fetches = stages.count["sweep:tile"] + stages.count["sweep:row"]
        assert stages.counters["store:h2d_copies"] == fetches
    finally:
        stages.enabled = False
        stages.reset()
    if held_back:
        assert waits > 0
    assert waits <= fetches - harness.STAGE_RING

    class Upload:
        def __init__(self, desc, tile, device):
            self.block = lambda i: harness._upload(harness._tile_slice(
                desc, i * tile, (i + 1) * tile, tile), device)

    monkeypatch.setattr(harness, "_TileStager", Upload)
    want = harness.run_pairwise(Serra09(), store, n, tile=4, device=dev,
                                device_resident=False)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


# the families whose sweep is one fp32 Gram, with their CPU tolerance
# (ANF's distances: rtol 1e-5 and 1e-5 of the largest, see test_torch_anf)
GRAM_FAMILIES = {"FTM2D": (FTM2D, 0.0), "ANFScattering": (ANFScattering,
                                                           1e-5)}


@pytest.mark.parametrize("family", list(GRAM_FAMILIES))
def test_full_scores_gram_keeps_tf32_off(dev, family):
    """`full_scores` on the card with TF32 switched ON globally (as a
    caller of `run_pairwise` without `benchmark()` may leave it) equals
    the plain CPU Gram to rtol 1e-5: the function switches TF32 off for
    its Gram and gives the caller's setting back."""
    cls, atol_frac = GRAM_FAMILIES[family]
    fs = make_synthetic_dataset(n_cliques=4, clique_size=2, seed=1,
                                base_duration=60.0)
    algo = cls()
    desc = algo.extract_descriptors(fs, device=dev)
    want = algo.full_scores(descriptors_from_numpy(desc, "cpu"))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = algo.full_scores(descriptors_from_numpy(desc, dev))
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    off = ~torch.eye(fs.n_songs, dtype=torch.bool)
    for k in algo.SIMILARITY_TYPES:
        g, w = got[k].cpu()[off], want[k][off]
        torch.testing.assert_close(g, w, rtol=1e-5,
                                   atol=atol_frac * float(w.max()))


@pytest.mark.parametrize("family", ["ChenFusion", "TGAlg"])
def test_row_knn_tile_on_the_card_equals_cpu(dev, family):
    """ChenFusion's and TGAlg's tile on the card (one qmax and one dmax
    launch on the stacked CRPs; the non-mutual row kNN a `torch.sort`)
    gives the CPU tile's scores bit for bit, and the kernels' plain
    versions on the card the same."""
    cls = {"ChenFusion": ChenFusion, "TGAlg": TGAlg}[family]
    fs = make_synthetic_dataset(n_cliques=3, clique_size=2, seed=1,
                                base_duration=300.0, beat_period=30.0)
    algo = cls()
    desc = algo.extract_descriptors(fs, device="cpu")
    cpu = descriptors_from_numpy(desc, "cpu")
    card = descriptors_from_numpy(desc, dev)
    q, d = alignment_cuda.qmax_batch_cuda, alignment_cuda.dmax_batch_cuda
    before = (q.launches, d.launches)
    got = algo.tile_scores(card, card)
    torch.cuda.synchronize()
    assert (q.launches, d.launches) == (before[0] + 1, before[1] + 1)
    plain = algo.tile_scores(card, card, plain=True)
    want = algo.tile_scores(cpu, cpu)
    for k in algo.SIMILARITY_TYPES:
        assert torch.equal(got[k], plain[k]), k
        assert torch.equal(got[k].cpu(), want[k]), k
        assert float(got[k].min()) > 0, k


def test_chen_fusion_late_snf_on_the_card(dev):
    """ChenFusion's late SNF on the card (the kNN row-mask kernel, one
    launch) against the CPU run: rtol 1e-4, as the SNF tests state."""
    rng = np.random.default_rng(3)
    n = 40
    Ds = {}
    for k in ChenFusion.SIMILARITY_TYPES:
        D = rng.random((n, n)).astype(np.float32) * 40 + 1
        Ds[k] = np.tril(D, -1) + np.tril(D, -1).T
    desc = {"length": rng.integers(200, 500, n).astype(np.int32)}
    before = crp_cuda.knn_mask_matrix_batch.launches
    got = ChenFusion().post_process(Ds, desc, device=dev)
    assert crp_cuda.knn_mask_matrix_batch.launches == before + 1
    want = ChenFusion().post_process(Ds, desc, device="cpu")
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-7)


def test_simple_asymmetric_sweep_on_the_card_equals_cpu(dev):
    """Simple's full-grid (asymmetric) sweep on the card equals the CPU
    sweep of the same descriptors, rtol 1e-5 (fp32 CSMs of two
    matmuls); every tile of the 3 x 3 grid is scored."""
    from acoss_tpu_torch.benchmarking.harness import run_pairwise

    fs = make_synthetic_dataset(n_cliques=6, clique_size=2, seed=2,
                                base_duration=120.0)
    algo = Simple()
    desc = algo.extract_descriptors(fs, device=dev)
    calls = []

    class Counted(Simple):
        def tile_scores(self, row, col):
            assert row["feat"].is_cuda and col["feat"].is_cuda
            calls.append(1)
            return super().tile_scores(row, col)

    got = run_pairwise(Counted(), desc, fs.n_songs, tile=5, device=dev)
    want = run_pairwise(algo, desc, fs.n_songs, tile=5, device="cpu")
    assert len(calls) == 9
    np.testing.assert_allclose(got["main"], want["main"], rtol=1e-5, atol=0)
    off = ~np.eye(fs.n_songs, dtype=bool)
    assert (got["main"][off] < 0).all()


STRUC_SMALL = dict(wins_per_block=5, K=5, niters=5, tempogram_win=96)


def test_struc_fused_w_on_the_card(dev):
    """The Struc* corpus fusion on the card (one kNN-mask launch a chunk
    of the (B F, npad, npad) stack) against the CPU run: fp32 tolerance,
    or where a near-tie rank flips a neighbour the JAX package's own
    bound (mean abs < 1e-4, max < 5% of max |W|)."""
    from acoss_tpu_torch.benchmarking.algorithms import struct_common

    fs = make_synthetic_dataset(n_cliques=3, clique_size=2, seed=1,
                                base_duration=60.0)
    before = crp_cuda.knn_mask_matrix_batch.launches
    got = struct_common.structural_fused_w_all(fs, **STRUC_SMALL,
                                               batch_size=4, device=dev)
    launches = crp_cuda.knn_mask_matrix_batch.launches - before
    want = struct_common.structural_fused_w_all(fs, **STRUC_SMALL,
                                                batch_size=4, device="cpu")
    assert launches == 2                     # 6 songs in chunks of 4
    for (Wg, og, ng), (Ww, ow, nw) in zip(got, want):
        assert ng == nw and np.array_equal(og, ow)
        err = np.abs(Wg - Ww)
        assert err.mean() < 1e-4 and err.max() < 0.05 * np.abs(Ww).max()


@pytest.mark.parametrize("do_fft", [True, False])
def test_shingle_topk_on_the_card(dev, do_fft):
    """The canvas FFT and top-k on the card against the CPU: kept sets
    differ only at cutoff ties within 1e-5, values within 1e-5."""
    from acoss_tpu_torch.ops import structure

    rng = np.random.default_rng(2)
    lengths = np.array([400, 512, 333], np.int32)
    W = np.zeros((3, 512, 512), np.float32)
    for b, n in enumerate(lengths):
        W[b, :n, :n] = rng.random((n, n), dtype=np.float32)
    P, n_keep = 2000, 10000
    gi, gv = (t.cpu().numpy() for t in structure.shingle_topk_batch(
        torch.from_numpy(W).to(dev), lengths, P, n_keep, do_fft))
    wi, wv = (t.numpy() for t in structure.shingle_topk_batch(
        torch.from_numpy(W), lengths, P, n_keep, do_fft))
    for b in range(3):
        g = dict(zip(gi[b][gi[b] >= 0].tolist(), gv[b][gi[b] >= 0]))
        w = dict(zip(wi[b][wi[b] >= 0].tolist(), wv[b][wi[b] >= 0]))
        cutoff = np.sort(wv[b][wi[b] >= 0])[::-1][n_keep - 1]
        for j in set(g) ^ set(w):
            assert abs(g.get(j, w.get(j)) - cutoff) < 1e-5
        assert max(abs(g[j] - w[j]) for j in set(g) & set(w)) < 1e-5


def test_sparse_gram_on_the_card_keeps_tf32_off(dev):
    """The union Gram on the card, with TF32 switched ON globally, within
    rtol 1e-5 of the float64 SpGEMM, over several row blocks."""
    from acoss_tpu_torch.ops import sparse_gram

    rng = np.random.default_rng(0)
    dim, idx, val = 200_000, [], []
    shared = rng.choice(dim, 3000, replace=False)
    for _ in range(70):
        ix = np.unique(np.concatenate([rng.choice(shared, 2000, False),
                                       rng.choice(dim, 500, False)]))
        idx.append(ix.astype(np.int64))
        val.append((rng.random(ix.size) * 0.02).astype(np.float32))
    want = sparse_gram.host_gram_scores(
        idx, [v.astype(np.float64) for v in val], dim)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = sparse_gram.sparse_gram_scores(idx, val, dim,
                                             force_device=True,
                                             max_row_block=32, device=dev)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_struc_laplacian_tile_on_the_card(dev):
    """StrucLaplacian's tile on the card: one qmax and one dmax launch on
    the stacked CRPs, equal to the kernels' plain versions on the card;
    on the CPU's CRPs the kernels give the CPU tile's scores bit for bit.
    The CRPs themselves differ from the CPU's only in cells whose CSM value
    sits within the two matmuls' rounding of its row's k-th value: the
    profiles hold long runs of near-zero velocity, so their CSMs are full
    of near-ties."""
    from acoss_tpu_torch.benchmarking.algorithms import StrucLaplacian
    from acoss_tpu_torch.ops import crp

    fs = make_synthetic_dataset(n_cliques=3, clique_size=2, seed=1,
                                base_duration=120.0)
    algo = StrucLaplacian(**STRUC_SMALL, neigs=6, m=6)
    desc = algo.extract_descriptors(fs, device="cpu")
    cpu = descriptors_from_numpy(desc, "cpu")
    card = descriptors_from_numpy(desc, dev)
    q, d = alignment_cuda.qmax_batch_cuda, alignment_cuda.dmax_batch_cuda
    before = (q.launches, d.launches)
    got = algo.tile_scores(card, card)
    torch.cuda.synchronize()
    assert (q.launches, d.launches) == (before[0] + 1, before[1] + 1)
    plain = algo.tile_scores(card, card, plain=True)
    for k in algo.SIMILARITY_TYPES:
        assert torch.equal(got[k], plain[k]), k
        assert float(got[k].max()) > 0, k
    # the aligners on the CPU's CRPs
    B, l1, l2 = algo.tile_crps(cpu, cpu)
    L = B.shape[-1]
    S, ml, nl = B.reshape(-1, L, L), l1.reshape(-1), l2.reshape(-1)
    denom = torch.clamp_min(ml + nl, 1).to(torch.float32)
    for fn, k in ((alignment.qmax_batch_best, "snovfn_qmax"),
                  (alignment.dmax_batch_best, "snovfn_dmax")):
        on_card = fn(S.to(dev), ml.to(dev), nl.to(dev)).cpu() / denom
        want = algo.tile_scores(cpu, cpu)[k].reshape(-1)
        assert torch.equal(on_card, want), k
    # where the CRPs differ, the CSM ties the row's k-th value to rounding
    Bg, _, _ = algo.tile_crps(card, card)
    csm = crp.get_csm(cpu["profile"][:, None], cpu["profile"][None])
    csm_g = crp.get_csm(card["profile"][:, None],
                        card["profile"][None]).cpu()
    eps = float((csm - csm_g).abs().max())
    valid = (torch.arange(L) < l2[..., None])[..., None, :]
    kth = torch.sort(torch.where(valid, csm, float("inf")), dim=-1).values
    kk = torch.round(l2.float() * algo.kappa).long().clamp_min(1)
    thr = torch.gather(kth, -1, (kk - 1)[..., None, None].expand(
        kth.shape[:-1] + (1,)))
    diff = Bg.cpu() != B
    if diff.any():
        assert float((csm - thr).abs()[diff].max()) <= 2 * eps


def test_laplacian_profile_on_the_card(dev):
    """The profile stage on the card (eigh, k-means, SVD) on W whose
    clusterings are deterministic: the velocity profiles equal the CPU's
    to atol 1e-4."""
    from acoss_tpu_torch.benchmarking.algorithms import StrucLaplacian
    from acoss_tpu_torch.ops import structure

    sizes = [(60, 40, 51), (27, 75, 33)]
    W = np.zeros((2, 256, 256), np.float32)
    times = np.full((2, 256), 1e18, np.float32)
    aff = np.array([[1.0, 0.05, 1e-4], [0.05, 1.0, 1e-4],
                    [1e-4, 1e-4, 1.0]], np.float32)
    lengths = []
    for b, s in enumerate(sizes):
        lab = np.repeat(np.arange(3), s)
        W[b, :lab.size, :lab.size] = aff[lab[:, None], lab[None, :]]
        times[b, :lab.size] = 1.0 + 0.5 * np.arange(lab.size)
        lengths.append(lab.size)
    lengths = np.array(lengths, np.int32)
    algo = StrucLaplacian(neigs=3, m=4)
    outs = []
    for device in (dev, "cpu"):
        X, nmeet = structure.laplacian_profile_batch(
            torch.from_numpy(W).to(device), lengths, times, 3, 384)
        outs.append([algo._profile_from_curve(
            X[b, :int(nmeet[b])].cpu().numpy().astype(np.float64))
            for b in range(2)])
    for g, w in zip(*outs):
        assert g.shape == w.shape and w.max() > 0.01
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)


# ------------------------------------------- feature extraction (L1) --

def _hmm_inputs(T: int, C: int = 25, seed: int = 0, flat: bool = False):
    from acoss_tpu_torch.features import chord

    rng = np.random.default_rng(seed)
    logits = np.zeros((T, C)) if flat else rng.normal(0, 4, (T, C))
    le = torch.log_softmax(torch.from_numpy(logits.astype(np.float32)), 1)
    lt = chord.log_transitions(C, 0.97) if C == 25 else np.log(
        rng.dirichlet(np.ones(C), C)).astype(np.float32)
    return le.contiguous(), torch.from_numpy(lt)


@pytest.mark.parametrize("T,C,flat,chunk", [
    (1, 25, False, None), (2, 25, False, None), (37, 25, False, None),
    (6000, 25, False, None), (500, 25, True, None), (300, 7, False, None),
    (300, 32, False, None), (26000, 25, False, None),
    (64, 25, False, 64), (65, 25, False, 64), (127, 25, False, 64),
    (65, 32, False, 64), (127, 7, False, 64), (25832, 25, False, None)])
def test_hmm_fb_kernel_matches_plain(dev, monkeypatch, T, C, flat, chunk):
    """The forward-backward kernel against its plain version and the plain
    model of its chunked algorithm on the card (random emissions; T = 1;
    all-equal emissions; 7 and 32 states; 5-minute songs of 26,000 and
    25,832 frames; the chunk edges T = L, L + 1 and 2L - 1 at L = 64,
    set in place of `chunk_length`'s):
    posteriors within atol 1e-5 (the log-sum-exps add in other orders;
    the messages are shifted to a largest entry of 0, so no error grows
    with T), one launch a call."""
    from acoss_tpu_torch.ops import hmm_cuda

    le, lt = _hmm_inputs(T, C, seed=T + C, flat=flat)
    le, lt = le.to(dev), lt.to(dev)
    L = chunk or hmm_cuda.chunk_length(T, hmm_cuda._sm_count(le.device))
    monkeypatch.setattr(hmm_cuda, "chunk_length", lambda *_: L)
    fn = hmm_cuda.chord_forward_backward
    before = fn.launches
    got = fn(le, lt)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = hmm_cuda.chord_forward_backward_ref(le, lt)
    assert got.shape == (T, C) and torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 1e-5
    model = hmm_cuda.chord_forward_backward_chunked_ref(le, lt, L)
    assert float((got - model).abs().max()) <= 1e-5
    torch.testing.assert_close(got.sum(1), torch.ones(T, device=dev),
                               rtol=0, atol=1e-5)
    if flat:   # uniform emissions under a symmetric prior: uniform
        torch.testing.assert_close(got, torch.full_like(got, 1 / C),
                                   rtol=0, atol=1e-6)


def _hmm_exact_inputs(kind: str):
    """Inputs whose one-frame products leave the linear range: spiky
    transitions (Dirichlet(0.05) rows, a -inf step out of every state)
    under emissions spread over hundreds of nats, or a song whose state
    changes every 100 frames under transitions of log -200."""
    if kind == "switch":
        A = torch.full((3, 3), -200.0)
        A.fill_diagonal_(0.0)
        E = torch.full((300, 3), -1000.0)
        E[torch.arange(300), (torch.arange(300) // 100) % 3] = 0.0
        return E, A
    rng = np.random.default_rng(3)
    C = 32
    logits = rng.normal(0, 40, (300, C)).astype(np.float32)
    le = torch.log_softmax(torch.from_numpy(logits), 1).contiguous()
    with np.errstate(divide="ignore"):
        lt = np.log(rng.dirichlet(np.full(C, 0.05), C)).astype(np.float32)
    lt = torch.from_numpy(lt)
    lt[torch.arange(C), (torch.arange(C) + 1) % C] = -torch.inf
    return le, lt


@pytest.mark.parametrize("kind,chunk", [("sticky", None), ("spiky", 16),
                                        ("switch", 16), ("switch", None)])
def test_hmm_fb_kernel_repeats_bit_for_bit(dev, monkeypatch, kind, chunk):
    """Two calls give the same bits (no atomics, no order-free sums: the
    crema feature feeds kNN ranks), on a 5,762-frame song and on inputs
    that take the kernel's exact log-space branch, which also agree with
    the plain version within atol 1e-5."""
    from acoss_tpu_torch.ops import hmm_cuda

    le, lt = (_hmm_inputs(5762, 25, seed=5) if kind == "sticky"
              else _hmm_exact_inputs(kind))
    le, lt = le.to(dev), lt.to(dev)
    if chunk:
        monkeypatch.setattr(hmm_cuda, "chunk_length", lambda *_: chunk)
    a = hmm_cuda.chord_forward_backward(le, lt)
    b = hmm_cuda.chord_forward_backward(le, lt)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    want = hmm_cuda.chord_forward_backward_ref(le, lt)
    assert float((a - want).abs().max()) <= 1e-5


def test_hmm_fb_kernel_rejects_what_it_does_not_take(dev):
    from acoss_tpu_torch.ops import hmm_cuda

    le, lt = _hmm_inputs(10, 25)
    with pytest.raises(ValueError):       # more states than lanes
        hmm_cuda.chord_forward_backward(torch.zeros(4, 33, device=dev),
                                        torch.zeros(33, 33, device=dev))
    with pytest.raises(ValueError):       # mixed devices
        hmm_cuda.chord_forward_backward(le.to(dev), lt)
    with pytest.raises(ValueError):       # not contiguous
        hmm_cuda.chord_forward_backward(le.to(dev).T.contiguous().T,
                                        lt.to(dev))


def _struc_corpus():
    return make_synthetic_dataset(n_cliques=3, clique_size=2, seed=1,
                                  base_duration=120.0)


def _assert_same_descriptors(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


def test_struc_laplacian_descriptors_repeat_bit_for_bit(dev):
    """Two extractions of StrucLaplacian's descriptors on the card are
    bit-identical: the tempogram segment sum, the stacked cosine norms,
    the SNF radii and the k-means draws' CDF are order-fixed there
    (index_add_ and torch.cumsum of floats on a CUDA tensor are not)."""
    from acoss_tpu_torch.benchmarking.algorithms import StrucLaplacian

    fs = _struc_corpus()
    algo = StrucLaplacian(**STRUC_SMALL, neigs=6, m=6)
    first = algo.extract_descriptors(fs, device=dev)
    second = algo.extract_descriptors(fs, device=dev)
    _assert_same_descriptors(first, second)
    assert float(np.abs(first["profile"]).max()) > 0


def test_tgalg_tempograms_repeat_bit_for_bit(dev):
    fs = make_synthetic_dataset(n_cliques=3, clique_size=2, seed=1,
                                base_duration=300.0, beat_period=30.0)
    algo = TGAlg()
    _assert_same_descriptors(algo.extract_descriptors(fs, device=dev),
                             algo.extract_descriptors(fs, device=dev))


def test_struc_laplacian_extraction_raises_no_determinism_alert(dev):
    """A diagnostic: StrucLaplacian's extraction once under
    torch.use_deterministic_algorithms(True, warn_only=True) alerts on no
    op. The mode only alerts on ops with no deterministic version (such
    as torch.cumsum of floats on CUDA); index_add_ and friends switch to
    one silently, which the repeat test above covers. cuBLAS's alert asks
    for CUBLAS_WORKSPACE_CONFIG, which matters only when streams share a
    workspace; the extraction runs on one stream, so it is recorded but
    not held against it."""
    import warnings

    from acoss_tpu_torch.benchmarking.algorithms import StrucLaplacian

    fs = _struc_corpus()
    algo = StrucLaplacian(**STRUC_SMALL, neigs=6, m=6)
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            algo.extract_descriptors(fs, device=dev)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
    alerts = sorted({str(w.message).splitlines()[0] for w in caught
                     if "determinis" in str(w.message)})
    print("determinism alerts:", alerts)
    assert [a for a in alerts if "CUBLAS_WORKSPACE_CONFIG" not in a] == []


def test_batch_extract_on_the_card_equals_cpu(dev, tmp_path):
    """The default profile extracted on the card against the CPU run of
    the same WAVs: labels and lengths equal, beat frames equal, arrays
    within 1e-4 of their largest magnitude (cuFFT and the CPU FFT round
    differently); one hmm_fb launch a song. HPCP picks each frame's 100
    largest spectral peaks (local maxima of a noisy spectrum), and a
    near-tied peak can enter or leave with the other FFT's rounding: its
    cells are within 1e-2 of the frame's unit maximum and at most 1 in
    100 of them outside 1e-4 (measured on the H100: 3.1e-3 and 1.5 in
    1,000)."""
    from acoss_tpu_torch.features import pipeline
    from acoss_tpu_torch.features.audio import save_wav
    from acoss_tpu_torch.ops import hmm_cuda

    rng = np.random.default_rng(4)
    sr = 44100
    paths = []
    for i, f0 in enumerate((196.0, 233.1, 261.6)):
        t = np.arange(int(sr * (8 + 2 * i))) / sr
        y = sum(np.sin(2 * np.pi * f0 * r * t) / r for r in (1, 1.26, 1.5))
        for b in np.arange(0.1, t[-1], 0.47):
            j = int(b * sr)
            y[j:j + 800] += rng.normal(size=len(y[j:j + 800])) * 0.8
        p = tmp_path / f"W_{i % 2}" / f"P_{i}.wav"
        p.parent.mkdir(exist_ok=True)
        save_wav(str(p), 0.3 * y / np.abs(y).max())
        paths.append(str(p))
    labels = [f"W_{i % 2}" for i in range(3)]
    fn = hmm_cuda.chord_forward_backward
    before = fn.launches
    card = pipeline.batch_extract(paths, labels, device=dev)
    assert fn.launches == before + 3
    cpu = pipeline.batch_extract(paths, labels, device="cpu")
    np.testing.assert_array_equal(card.labels, cpu.labels)
    for k in cpu.features:
        np.testing.assert_array_equal(card.length(k), cpu.length(k))
        got, want = card.feature(k), cpu.feature(k)
        err = np.abs(got - want) / float(np.abs(want).max())
        if k == "onsets":
            np.testing.assert_array_equal(got, want)
        elif k == "hpcp":
            assert float(err.max()) <= 1e-2
            assert float(np.mean(err > 1e-4)) <= 1e-2
        else:
            assert float(err.max()) <= 1e-4, k


def _serving_corpus():
    # 16 songs: two Serra09 tiles
    return make_synthetic_dataset(n_cliques=8, clique_size=2, seed=1,
                                  base_duration=30.0)


def test_index_query_rows_equal_sweep_rows_on_the_card(dev):
    """A CoverIndex on the card answers the query rows of the sweep over
    the union bit for bit (queries and corpus from one extraction, so one
    padded width), with qmax, dmax and the fused CRP launched twice a
    corpus tile (one call a channel)."""
    from acoss_tpu_torch.benchmarking.harness import run_pairwise
    from acoss_tpu_torch.serving import CoverIndex

    fs = _serving_corpus()
    algo = Serra09()
    desc = {k: np.asarray(v) for k, v in
            algo.extract_descriptors(fs, device=dev).items()}
    n, T = fs.n_songs, algo.TILE
    nc = n - T                           # the last block-row are queries
    D = run_pairwise(algo, desc, n, device=dev,
                     tile_filter=lambda ti, tj: ti == n // T - 1,
                     skip_symmetrize=True)
    index = CoverIndex(algo, {k: v[:nc] for k, v in desc.items()}, nc,
                       device=dev)
    wrappers = (alignment_cuda.qmax_batch_cuda,
                alignment_cuda.dmax_batch_cuda,
                crp_cuda.fused_binary_crp_batch)
    before = [w.launches for w in wrappers]
    got = index.query_descriptors({k: v[nc:] for k, v in desc.items()}, T)
    assert [w.launches - b for w, b in zip(wrappers, before)] == \
        [2 * index.n_tiles] * 3
    for k in algo.SIMILARITY_TYPES:
        np.testing.assert_array_equal(got[k], D[k][nc:, :nc], err_msg=k)


def test_process_shards_merge_on_the_card(dev, tmp_path):
    """Three shards on the card merge to the unsharded card sweep bit for
    bit."""
    from acoss_tpu_torch.benchmarking.harness import run_pairwise
    from acoss_tpu_torch.parallel import merge_partials, run_process_shard

    fs = _serving_corpus()
    algo = Serra09()
    desc = algo.extract_descriptors(fs, device=dev)
    want = run_pairwise(algo, desc, fs.n_songs, tile=4, device=dev)
    paths = [run_process_shard(algo, desc, fs.n_songs, p, 3, str(tmp_path),
                               tile=4, device=dev) for p in range(3)]
    merged = merge_partials(paths)
    for k in want:
        np.testing.assert_array_equal(merged[k], want[k], err_msg=k)


def test_shape_dna_knn_mask_equals_plain_on_the_card(dev):
    """Shape DNA launches the kNN row mask once a song, on its (2, npad,
    npad) stack; the mask equals the plain version's, so the eigenvalues
    equal the plain path's."""
    from acoss_tpu_torch.analytics import get_shape_dna

    fs = _serving_corpus()
    h = fs.feature("hpcp")[0, :fs.length("hpcp")[0]]
    m = fs.feature("mfcc_htk")[0, :fs.length("mfcc_htk")[0]]
    calls = []
    real = crp_cuda.knn_mask_matrix_batch

    def spy(W, k, largest=False):
        out = real(W, k, largest=largest)
        calls.append((W.clone(), k.clone(), largest, out))
        return out

    # the wrapper counts its launches through its module-level name
    spy.launches = 0
    crp_cuda.knn_mask_matrix_batch = spy
    try:
        got = get_shape_dna(h, m, device=dev)
    finally:
        crp_cuda.knn_mask_matrix_batch = real
    assert len(calls) == 1
    W, k, largest, out = calls[0]
    assert W.shape[0] == 2 and W.shape[1] == W.shape[2]
    ref = crp_cuda.knn_mask_matrix_ref(W, k, largest=largest)
    assert torch.equal(out, ref)
    crp_cuda.knn_mask_matrix_batch = crp_cuda.knn_mask_matrix_ref
    try:
        plain = get_shape_dna(h, m, device=dev)
    finally:
        crp_cuda.knn_mask_matrix_batch = real
    np.testing.assert_array_equal(got["w"], plain["w"])


def test_kernel_wrappers_keep_the_callers_device(dev):
    """Every kernel wrapper launches on its tensors' device (card 0) and
    leaves the caller's current device as it was: the C entry points
    restore it. With two or more cards the caller's current device is the
    last card, another than the tensors'."""
    from acoss_tpu_torch.ops import hmm_cuda

    card = torch.device("cuda", 0)
    here = torch.cuda.device_count() - 1
    B, L = 8, 64
    S, m, n = (torch.from_numpy(a).to(card) for a in _crps(0, B=B, L=L))
    g = torch.Generator().manual_seed(0)
    X, Y = (torch.rand(B, L, 12, generator=g).to(card) for _ in range(2))
    M = torch.rand(B, L, L, generator=g).to(card)
    lens = torch.full((B,), L, dtype=torch.int32, device=card)
    calls = {
        "qmax": lambda: alignment_cuda.qmax_batch_cuda(S, m, n),
        "dmax": lambda: alignment_cuda.dmax_batch_cuda(S, m, n),
        "qmax_uneq": lambda: alignment_cuda.qmax_uneq_batch_cuda(
            S, m, n, 0.3, 0.8),
        "sw": lambda: alignment_cuda.swconstrained_batch_cuda(S, m, n),
        "fused_crp": lambda: crp_cuda.fused_binary_crp_batch(X, Y, lens,
                                                             lens),
        "binarize": lambda: crp_cuda.binarize_matrix_batch(M, lens, lens),
        "knn_mask": lambda: crp_cuda.knn_mask_matrix_batch(M, lens // 8),
        "wcsmssm": lambda: crp_cuda.wcsmssm_batch(M, M, M, lens, lens,
                                                  lens // 8),
        "pair_operands": lambda: serra09_cuda.pair_operands_batch(
            X, X, X, X, lens, lens),
        "scores_epilogue": lambda: serra09_cuda.scores_epilogue_batch(
            [X[0, 0, :B]], [X[0, 1, :B]], lens, lens),
        "hmm_fb": lambda: hmm_cuda.chord_forward_backward(
            torch.rand(L, 25, generator=g).to(card),
            torch.rand(25, 25, generator=g).to(card)),
    }
    with torch.cuda.device(here):
        for name, call in calls.items():
            call()
            assert torch.cuda.current_device() == here, name
    torch.cuda.synchronize(card)


def _mesh_corpus(dev):
    fs = _serving_corpus()
    algo = Serra09()
    desc = {k: np.asarray(v) for k, v in
            algo.extract_descriptors(fs, device=dev).items()}
    return fs.n_songs, algo, desc


def test_mesh_over_one_card_equals_run_pairwise(dev):
    """A 2x2 mesh and a fold over 4 slots of card 0 equal the card's
    run_pairwise bit for bit (the rectangular sweep on the strict lower
    triangle, the fold whole), and leave the current device as it was."""
    from acoss_tpu_torch.benchmarking.harness import run_pairwise
    from acoss_tpu_torch.parallel import (make_pair_mesh, sharded_pair_scores,
                                          sharded_pair_scores_triangular)

    n, algo, desc = _mesh_corpus(dev)
    want = run_pairwise(algo, desc, n, device=dev)
    slots = [torch.device("cuda", 0)] * 4
    here = torch.cuda.current_device()
    rect = sharded_pair_scores(algo.tile_scores, desc, n,
                               make_pair_mesh(slots, (2, 2)))
    fold = sharded_pair_scores_triangular(algo.tile_scores, desc, n,
                                          devices=slots)
    assert torch.cuda.current_device() == here
    tril = np.tril_indices(n, -1)
    for k in want:
        np.testing.assert_array_equal(rect[k][tril], want[k][tril], err_msg=k)
        np.testing.assert_array_equal(fold[k], want[k], err_msg=k)


def test_mesh_over_four_cards_equals_run_pairwise(dev):
    """The fold and the 2x2 rectangle over cards 0-3 (blocks on distinct
    cards, enqueued round robin, the corpus restored on each card) equal
    card 0's run_pairwise bit for bit, called from a current device that
    is not the mesh's first; and the tile's kernel wrappers on every card
    leave the caller's current device as it was."""
    from acoss_tpu_torch.benchmarking.harness import run_pairwise
    from acoss_tpu_torch.data.descstore import upcast_stream
    from acoss_tpu_torch.parallel import (make_pair_mesh, sharded_pair_scores,
                                          sharded_pair_scores_triangular)
    from acoss_tpu_torch.parallel.mesh import _rows_on

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    n, algo, desc = _mesh_corpus(dev)
    cards = [torch.device("cuda", i) for i in range(4)]
    want = run_pairwise(algo, desc, n, device=cards[0])
    with torch.cuda.device(cards[2]):
        rect = sharded_pair_scores(algo.tile_scores, desc, n,
                                   make_pair_mesh(cards, (2, 2)))
        fold = sharded_pair_scores_triangular(algo.tile_scores, desc, n,
                                              devices=cards)
        assert torch.cuda.current_device() == 2
    tril = np.tril_indices(n, -1)
    for k in want:
        np.testing.assert_array_equal(rect[k][tril], want[k][tril], err_msg=k)
        np.testing.assert_array_equal(fold[k], want[k], err_msg=k)
    for i, card in enumerate(cards):
        here = (i + 1) % 4
        part = upcast_stream(_rows_on(desc, 0, 8, card))
        with torch.cuda.device(here):
            out = algo.tile_scores(part, part)
            assert torch.cuda.current_device() == here, card
        assert all(v.device == card for v in out.values())
        torch.cuda.synchronize(card)


def test_mesh_sub_blocks_on_the_card_equal_cpu(dev, monkeypatch):
    """A device block whose rows exceed MAX_PAIRS_PER_CALL // col_tile is
    split on the card (no call scores more than the constant), and the
    matrices equal the unsplit CPU sweep of the kernel path's plain
    composition (`tile_scores(plain=True)`) bit for bit."""
    import functools

    from acoss_tpu_torch.parallel import make_pair_mesh, mesh

    n, algo, desc = _mesh_corpus(dev)
    calls = []

    def counted(row, col):
        calls.append(row["length"].shape[0] * col["length"].shape[0])
        return algo.tile_scores(row, col)

    with monkeypatch.context() as mp:
        mp.setattr(mesh, "MAX_PAIRS_PER_CALL", 16)
        got = mesh.sharded_pair_scores(
            counted, desc, n, make_pair_mesh([torch.device("cuda", 0)] * 2,
                                             (1, 2)))
    assert max(calls) <= 16 and len(calls) > 2
    want = mesh.sharded_pair_scores(
        functools.partial(algo.tile_scores, plain=True), desc, n,
        make_pair_mesh([torch.device("cpu")] * 2, (1, 2)))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
