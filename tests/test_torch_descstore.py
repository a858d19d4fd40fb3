"""The port's disk descriptor store and lazy corpus against the JAX
package's: stores written by either package open in the other with
byte-equal files, the int8 dequant is bit-equal, the precision checks
agree, and `LazySyntheticCorpus` renders the same songs for any chunking."""

from tests import _torch_threads  # noqa: F401  (caps thread pools)

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acoss_tpu.benchmarking.harness import CoverAlgorithm as JaxAlgorithm
from acoss_tpu.data import descstore as jax_ds
from acoss_tpu.data.synthetic import LazySyntheticCorpus as JaxLazy
from acoss_tpu_torch.benchmarking.harness import CoverAlgorithm
from acoss_tpu_torch.data import LazySyntheticCorpus, descstore
from acoss_tpu_torch.data.store import FeatureSet


def _fs(n: int = 23, L: int = 40, seed: int = 0) -> FeatureSet:
    """Ragged songs of positive features (lengths 5..L)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(5, L + 1, n).astype(np.int32)
    vec = (rng.random((n, L, 6)) + 0.1).astype(np.float32)
    vec *= (np.arange(L)[None, :, None] < lens[:, None, None])
    return FeatureSet({"vec": vec}, {"vec": lens},
                      np.array([f"W{i // 3}" for i in range(n)]),
                      np.array([f"t{i}" for i in range(n)]))


def _ragged(fs) -> dict:
    """Descriptors padded to the subset's own longest song (chunk-local
    widths differ), a 1-D fp32 key and the lengths."""
    lens = np.asarray(fs.length("vec"))
    w = int(lens.max())
    v = np.asarray(fs.feature("vec")[:, :w], np.float32)
    return {"vec": v, "gvec": v.sum(1), "length": lens.astype(np.int32)}


class Ragged(CoverAlgorithm):
    def extract_descriptors(self, fs, device="cuda"):
        return _ragged(fs)


class JaxRagged(JaxAlgorithm):
    def extract_descriptors(self, fs):
        return _ragged(fs)


class TensorRagged(Ragged):
    """Returns its bulk descriptor as a tensor on the device, as Serra09's
    ssms and EarlySNF's descriptors are."""

    def extract_descriptors(self, fs, device="cuda"):
        d = _ragged(fs)
        d["vec"] = torch.from_numpy(d["vec"]).to(device)
        return d


def _files(path: str) -> dict:
    return {f: open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path))}


@pytest.mark.parametrize("quant", [None, "half", "int8"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_stores_are_byte_equal_and_open_in_both(tmp_path, writer, quant):
    fs = _fs()
    jax_path, port_path = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_ds.extract_streamed(JaxRagged(), fs, jax_path, chunk_songs=7,
                            quant=quant, half_min_bytes=64)
    alg = TensorRagged() if writer == "port" else Ragged()
    descstore.extract_streamed(alg, fs, port_path, chunk_songs=7,
                               quant=quant, half_min_bytes=64, device="cpu")
    files = _files(jax_path)
    assert files == _files(port_path)
    assert "descstore.json" in files and len(files) == 4 + (quant == "int8")
    src = jax_path if writer == "jax" else port_path
    got, want = descstore.DescriptorStore.open(src), \
        jax_ds.DescriptorStore.open(src)
    assert sorted(got) == sorted(want)
    for k in want:
        assert isinstance(got[k], np.memmap) and got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert descstore.store_quant(got) == jax_ds.store_quant(want) == quant
    if quant == "int8":
        assert got["vec"].dtype == np.int8 and "vec@qscale" in got
        assert got["gvec"].dtype == np.float32    # below half_min_bytes
    # the valid rows are the extraction's, whatever the chunking
    ref = _ragged(fs)
    np.testing.assert_array_equal(got["length"], ref["length"])
    if quant is None:
        np.testing.assert_array_equal(got["vec"], ref["vec"])


def test_quantize_int8_matches_jax():
    rng = np.random.default_rng(11)
    v = rng.standard_normal((6, 30, 40)).astype(np.float32) * \
        (10.0 ** rng.integers(-3, 3, size=(6, 1, 1)))
    v[2] = 0.0
    for got, want in zip(descstore.quantize_int8(v),
                         jax_ds.quantize_int8(v)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    q, s = descstore.quantize_int8(v)
    assert s[2] == 1.0 and not q[2].any()


def test_upcast_stream_bit_equal_to_jax():
    rng = np.random.default_rng(5)
    v = (rng.standard_normal((4, 8, 8)) * 37.0).astype(np.float32)
    q, s = descstore.quantize_int8(v)
    h = v[:, 0].astype(np.float16)
    lengths = np.full(4, 7, np.int32)
    got = descstore.upcast_stream({
        "ssms": torch.from_numpy(q), "ssms@qscale": torch.from_numpy(s),
        "half": torch.from_numpy(h), "length": torch.from_numpy(lengths),
        "plain": torch.from_numpy(v)})
    want = jax_ds.upcast_stream({
        "ssms": jnp.asarray(q), "ssms@qscale": jnp.asarray(s),
        "half": jnp.asarray(h), "length": jnp.asarray(lengths),
        "plain": jnp.asarray(v)})
    assert sorted(got) == sorted(want) == ["half", "length", "plain", "ssms"]
    for k in want:
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_allclose(got["ssms"].numpy(), v,
                               atol=np.abs(v).max() / 127)
    # a bare int8 key (no companion) and a bf16 key
    out = descstore.upcast_stream({"i": torch.from_numpy(q),
                                   "b": torch.ones(2, dtype=torch.bfloat16)})
    assert out["i"].dtype == torch.int8 and out["b"].dtype == torch.float32


@pytest.mark.parametrize("have", [None, "half", "int8"])
def test_stream_consistency_matches_jax(tmp_path, have, capsys):
    store = descstore.extract_streamed(Ragged(), _fs(10), str(tmp_path / "s"),
                                       chunk_songs=5, quant=have,
                                       half_min_bytes=64, device="cpu")
    for want in (None, "half", "int8"):
        outcomes = []
        for check in (descstore.check_stream_consistency,
                      jax_ds.check_stream_consistency):
            try:
                check(store, want, "p")
                outcomes.append("ok")
            except ValueError as e:
                outcomes.append(str(e))
        assert outcomes[0] == outcomes[1], (have, want)
        rank = {None: 0, "half": 1, "int8": 2}
        assert (outcomes[0] == "ok") == (rank[have] <= rank[want])
    assert "note:" in capsys.readouterr().err or have == "int8"


def test_extract_streamed_clears_stale_store(tmp_path):
    path = str(tmp_path / "store")
    os.makedirs(path)
    np.lib.format.open_memmap(os.path.join(path, "vec.npy"), mode="w+",
                              dtype=np.float32, shape=(12, 2, 6))
    desc = descstore.extract_streamed(Ragged(), _fs(12), path, chunk_songs=5,
                                      device="cpu")
    assert desc["vec"].shape[1] > 2
    assert os.path.exists(os.path.join(path, descstore.DescriptorStore.META))
    assert not os.path.exists(path + ".chunks")


def test_quantized_keys_decided_on_the_first_chunk(tmp_path):
    """A key whose chunk-local width straddles the threshold is compressed
    in every chunk or in none, as the first chunk decides."""
    fs = _fs(20)
    first = _ragged(fs.subset(np.arange(7)))["vec"][:1].nbytes
    for min_bytes, dtype in ((first + 1, np.float32), (first, np.int8)):
        d = descstore.extract_streamed(
            Ragged(), fs, str(tmp_path / f"s{min_bytes}"), chunk_songs=7,
            quant="int8", half_min_bytes=min_bytes, device="cpu")
        w = jax_ds.extract_streamed(
            JaxRagged(), fs, str(tmp_path / f"j{min_bytes}"), chunk_songs=7,
            quant="int8", half_min_bytes=min_bytes)
        assert d["vec"].dtype == w["vec"].dtype == dtype
        assert _files(str(tmp_path / f"s{min_bytes}")) == \
            _files(str(tmp_path / f"j{min_bytes}"))


def test_unsupported_descriptor_raises(tmp_path):
    class Bad(Ragged):
        def extract_descriptors(self, fs, device="cuda"):
            return {"x": np.float32(1.0)}

    with pytest.raises(ValueError, match="streamed extraction"):
        descstore.extract_streamed(Bad(), _fs(4), str(tmp_path / "s"),
                                   device="cpu")
    with pytest.raises(ValueError, match="quant"):
        descstore.extract_streamed(Ragged(), _fs(4), str(tmp_path / "s"),
                                   quant="int4", device="cpu")


LAZY = dict(n_cliques=3, clique_size=3, n_distractors=2, base_duration=6.0,
            beat_period=4.0)


def test_lazy_corpus_layout_matches_jax():
    c, j = LazySyntheticCorpus(**LAZY), JaxLazy(**LAZY)
    assert c.n_songs == j.n_songs == 11
    np.testing.assert_array_equal(c.labels, j.labels)
    np.testing.assert_array_equal(c.track_ids, j.track_ids)
    assert c.labels[-1] == "W_d1" and c.track_ids[4] == "W_1/P_1"


@pytest.mark.parametrize("chunks", [[11], [4, 7], [1, 5, 2, 3]])
def test_lazy_corpus_chunks_render_jax_songs(chunks):
    """Any chunking of the port's corpus renders the JAX package's songs
    bit for bit (valid frames; the padded widths are chunk-local)."""
    c = LazySyntheticCorpus(**LAZY, seed=3)
    full = JaxLazy(**LAZY, seed=3).subset(np.arange(11))
    lo = 0
    for size in chunks:
        sub = c.subset(np.arange(lo, lo + size))
        for k in full.features:
            assert sub.features[k].dtype == full.features[k].dtype, k
            for i in range(size):
                n = int(full.lengths[k][lo + i])
                assert int(sub.lengths[k][i]) == n
                np.testing.assert_array_equal(
                    sub.features[k][i][:n], full.features[k][lo + i][:n],
                    err_msg=f"{k}[{lo + i}]")
        np.testing.assert_array_equal(sub.labels, full.labels[lo:lo + size])
        lo += size
