"""The port's qmax / dmax / constrained-SW aligners against the JAX
package: the Pallas kernels in interpret mode, the XLA scans (including
unequal gaps), the numpy DP oracles and the native C++ aligners (the JAX
package's and the port's own copy). Scores are integers and halves (or
sums of fp32-rounded gaps computed in the same order), so the port must
agree exactly; only the Pallas SW kernel, which reassociates its sums,
is held within the JAX package's own bound (atol 1e-4)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acoss_tpu import native as jax_native
from acoss_tpu.ops import alignment as jax_alignment
from acoss_tpu.ops import alignment_pallas
from acoss_tpu_torch import native
from acoss_tpu_torch.ops import alignment, alignment_cuda
from tests import oracles

# (port wrapper, its plain version, keyword arguments) of every aligner
# kernel; qmax_uneq with the legacy surface's unequal gaps
WRAPPERS = {
    "qmax": ("qmax_batch_cuda", "qmax_batch_ref", {}),
    "dmax": ("dmax_batch_cuda", "dmax_batch_ref", {}),
    "qmax_uneq": ("qmax_uneq_batch_cuda", "qmax_uneq_batch_ref",
                  {"gap_onset": 0.3, "gap_extension": 0.8}),
    "sw": ("swconstrained_batch_cuda", "swconstrained_batch_ref", {}),
}

# ragged sizes incl. sides below 3 / 4 (the early-outs), a zero length
# and full-size pairs
SIZES = [(40, 40), (31, 36), (2, 10), (3, 3), (4, 9), (0, 17),
         (40, 5), (23, 40)]


def _ragged_batch(seed, density=0.25, M=40, N=40):
    rng = np.random.default_rng(seed)
    S = np.zeros((len(SIZES), M, N), dtype=np.uint8)
    for b, (m, n) in enumerate(SIZES):
        S[b, :m, :n] = rng.random((m, n)) < density
    ml = np.array([s[0] for s in SIZES], np.int32)
    nl = np.array([s[1] for s in SIZES], np.int32)
    return S, ml, nl


def _port(fn, S, ml, nl, **kw):
    return fn(torch.from_numpy(S), torch.from_numpy(ml),
              torch.from_numpy(nl), **kw).numpy()


@pytest.mark.parametrize("name", ["qmax", "dmax"])
@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_ref_matches_pallas_interpret(name, seed):
    S, ml, nl = _ragged_batch(seed)
    pallas = getattr(alignment_pallas, f"{name}_batch_pallas")
    want = np.asarray(pallas(S, ml, nl, gap=0.5, block_b=8, block_t=8,
                             interpret=True))
    ref = getattr(alignment_cuda, f"{name}_batch_ref")
    np.testing.assert_array_equal(_port(ref, S, ml, nl, gap=0.5), want)


@pytest.mark.parametrize("name", ["qmax", "dmax"])
@pytest.mark.parametrize("gaps", [(0.5, 0.5), (0.3, 0.7), (1.0, 0.25),
                                  (-0.2, -0.2)])
def test_plain_scan_matches_xla_scan(name, gaps):
    S, ml, nl = _ragged_batch(2)
    go, ge = gaps
    want = np.asarray(getattr(jax_alignment, f"{name}_batch")(
        S, ml, nl, gap_onset=go, gap_extension=ge))
    got = _port(getattr(alignment, f"{name}_batch"), S, ml, nl,
                gap_onset=go, gap_extension=ge)
    np.testing.assert_array_equal(got, want)
    # on CPU tensors the dispatcher takes the plain scan for every gap
    got_best = _port(getattr(alignment, f"{name}_batch_best"), S, ml, nl,
                     gap_onset=go, gap_extension=ge)
    np.testing.assert_array_equal(got_best, want)


@pytest.mark.parametrize("name", ["qmax", "dmax", "swconstrained"])
def test_plain_scan_matches_numpy_oracle(name):
    S, ml, nl = _ragged_batch(3)
    got = _port(getattr(alignment, f"{name}_batch"), S, ml, nl)
    oracle = getattr(oracles, f"{name}_np")
    want = [oracle(S[b, :m, :n]) for b, (m, n) in enumerate(SIZES)]
    # the oracles run in float64: qmax/dmax scores (integers and halves)
    # are exact in both, SW's -0.7 gap is not exact in float32
    atol = 1e-4 if name == "swconstrained" else 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("params", [
    {},
    {"gap_opening": -0.3, "gap_extension": -0.9},
    {"match_score": 2.0, "mismatch_score": -0.5},
    {"gap_opening": 0.2, "gap_extension": -0.7},
])
def test_swconstrained_matches_xla_scan(params):
    S, ml, nl = _ragged_batch(4, density=0.4)
    want = np.asarray(jax_alignment.swconstrained_batch(S, ml, nl, **params))
    got = _port(alignment.swconstrained_batch, S, ml, nl, **params)
    np.testing.assert_array_equal(got, want)
    got_best = _port(alignment.swconstrained_batch_best, S, ml, nl, **params)
    np.testing.assert_array_equal(got_best, want)


def test_plain_scan_accepts_scalar_lengths_and_single_pair():
    S, _, _ = _ragged_batch(5)
    want = np.asarray(jax_alignment.qmax_batch(S[:1], 40, 40))
    got = alignment.qmax_batch(torch.from_numpy(S[0]), 40, 40).numpy()
    np.testing.assert_array_equal(got, want)
    # S may hold anything in the padding: the scans mask by length
    noisy = S.copy()
    noisy[:, 35:, :] = 1
    want = np.asarray(jax_alignment.dmax_batch(
        jnp.asarray(noisy), np.full(len(SIZES), 35), np.full(len(SIZES), 40)))
    got = alignment.dmax_batch(torch.from_numpy(noisy), 35, 40).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_wrapper_takes_plain_version_on_cpu(name):
    S, ml, nl = _ragged_batch(6)
    wname, rname, kw = WRAPPERS[name]
    wrapper = getattr(alignment_cuda, wname)
    ref = getattr(alignment_cuda, rname)
    before = wrapper.launches
    np.testing.assert_array_equal(_port(wrapper, S, ml, nl, **kw),
                                  _port(ref, S, ml, nl, **kw))
    assert wrapper.launches == before      # no kernel launched on the CPU


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_wrapper_refuses_other_devices(name):
    """No silent fallback: a tensor that is neither on the CPU nor on a
    CUDA device is refused, never computed by the plain version."""
    S, ml, nl = _ragged_batch(7)
    wname, _, kw = WRAPPERS[name]
    wrapper = getattr(alignment_cuda, wname)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        wrapper(torch.from_numpy(S).to("meta"),
                torch.from_numpy(ml).to("meta"),
                torch.from_numpy(nl).to("meta"), **kw)


def _rows01_batch(seed):
    """The ragged batch with every cell of rows 0 and 1 a match: the
    unequal-gap penalties of row 2's predecessors come from those rows."""
    S, ml, nl = _ragged_batch(seed, density=0.3)
    for b, (m, n) in enumerate(SIZES):
        S[b, :min(m, 2), :n] = 1
    return S, ml, nl


@pytest.mark.parametrize("gaps", [(0.3, 0.8), (0.8, 0.3), (0.0, 1.0),
                                  (0.5, 0.5)])
@pytest.mark.parametrize("seed", [8, 9])
def test_qmax_uneq_ref_matches_xla_scan_and_pallas(gaps, seed):
    """The unequal-gap kernel's plain version equals the XLA scan bit for
    bit and the Pallas kernel in interpret mode (also bit for bit here:
    the Pallas kernel does the same fp32 operations)."""
    S, ml, nl = _rows01_batch(seed)
    go, ge = gaps
    got = _port(alignment_cuda.qmax_uneq_batch_ref, S, ml, nl,
                gap_onset=go, gap_extension=ge)
    np.testing.assert_array_equal(got, np.asarray(jax_alignment.qmax_batch(
        S, ml, nl, gap_onset=go, gap_extension=ge)))
    pallas = np.asarray(alignment_pallas.qmax_batch_pallas_uneq(
        S, ml, nl, gap_onset=go, gap_extension=ge, block_b=8, block_t=8,
        interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-4)
    assert got[0] > 0 and got[2] == 0 and got[5] == 0


@pytest.mark.parametrize("params", [
    {},
    {"gap_opening": -0.3, "gap_extension": -0.9},
    {"match_score": 2.0, "mismatch_score": -0.5},
])
@pytest.mark.parametrize("seed", [10, 11])
def test_sw_ref_matches_xla_scan_and_pallas(params, seed):
    """The SW kernel's plain version equals the XLA scan bit for bit, and
    the Pallas kernel (interpret mode), which reassociates its sums,
    within the JAX package's bound atol 1e-4 (the largest difference is
    in the message)."""
    S, ml, nl = _rows01_batch(seed)
    got = _port(alignment_cuda.swconstrained_batch_ref, S, ml, nl, **params)
    np.testing.assert_array_equal(got, np.asarray(
        jax_alignment.swconstrained_batch(S, ml, nl, **params)))
    pallas = np.asarray(alignment_pallas.swconstrained_batch_pallas(
        S, ml, nl, block_b=8, block_t=8, interpret=True, **params))
    diff = float(np.abs(got - pallas).max())
    print(f"SW {params} seed {seed}: largest |plain - Pallas| {diff}")
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-4,
                               err_msg=f"largest difference {diff}")
    assert got[0] > 0 and got[2] == 0 and got[5] == 0


NATIVE_CASES = [("qmax", {}), ("qmax", {"gap_onset": 0.3,
                                        "gap_extension": 0.8}),
                ("dmax", {}), ("dmax", {"gap_onset": 0.8,
                                        "gap_extension": 0.3}),
                ("swconstrained", {}),
                ("swconstrained", {"gap_opening": -0.3,
                                   "gap_extension": -0.9})]


@pytest.mark.parametrize("name,kw", NATIVE_CASES)
def test_native_copy_matches_jax_native_and_plain_scan(name, kw):
    """The port's C++ copy equals the JAX package's native library and
    the plain scans bit for bit, batched and single-pair, with noise in
    the padding (the native batch reads only each pair's window)."""
    S, ml, nl = _rows01_batch(12)
    S[:, 38:, :] = 1
    ml, nl = np.minimum(ml, 38), np.minimum(nl, 38)
    got = getattr(native, f"{name}_batch_cpu")(S, ml, nl, **kw)
    want = getattr(jax_native, f"{name}_batch_cpu")(S, ml, nl, **kw)
    np.testing.assert_array_equal(got, want)
    plain = _port(getattr(alignment, f"{name}_batch"), S, ml, nl, **kw)
    np.testing.assert_array_equal(got, plain)
    assert got.max() > 0
    single = getattr(native, f"{name}_cpu")(S[0, :ml[0], :nl[0]], **kw)
    assert single == got[0] == \
        getattr(jax_native, f"{name}_cpu")(S[0, :ml[0], :nl[0]], **kw)


@pytest.mark.parametrize("name,kw", NATIVE_CASES)
def test_single_pair_aligners_match_jax(name, kw):
    """The port's single-pair qmax / dmax / swconstrained (through the
    `*_best` dispatchers) equal the JAX package's single-pair scans, with
    and without explicit lengths."""
    S, _, _ = _rows01_batch(13)
    fn, jfn = getattr(alignment, name), getattr(jax_alignment, name)
    for args in ((), (31, 36)):
        got = fn(torch.from_numpy(S[0]), *args, **kw)
        assert got.shape == () and got.dtype == torch.float32
        assert float(got) == float(jfn(S[0], *args, **kw))
    assert float(fn(S[0], **kw)) > 0          # numpy input
