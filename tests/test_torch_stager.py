"""The streamed sweep's tile stager (`harness._TileStager`) on the CPU: its
slab layout and the rows it unpacks, against `_tile_slice` and `_upload`
over a Serra09 int8 descriptor store, and the streamed `run_pairwise`
that runs it. (On the CPU the slabs are not pinned and no event is
recorded; the card tests in `test_torch_cuda.py` run the non-blocking
copy.)"""

from tests import _torch_threads  # noqa: F401  (caps thread pools)

import numpy as np
import pytest
import torch

from acoss_tpu_torch.benchmarking import harness
from acoss_tpu_torch.benchmarking.algorithms import Serra09
from acoss_tpu_torch.data import LazySyntheticCorpus
from acoss_tpu_torch.data.descstore import extract_streamed
from acoss_tpu_torch.utils import profiling

TILE = 4


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """Serra09's int8 store of 9 songs: two full tiles of 4 and a last
    tile of one song."""
    corpus = LazySyntheticCorpus(n_cliques=2, clique_size=3,
                                 n_distractors=3)
    s = extract_streamed(Serra09(), corpus,
                         str(tmp_path_factory.mktemp("stager") / "store"),
                         quant="int8", half_min_bytes=16384, device="cpu")
    assert sorted(s) == ["chroma", "chroma@qscale", "gchroma", "length",
                         "mfcc", "mfcc@qscale"]
    assert s["chroma"].dtype == np.int8 and len(s["length"]) == 9
    return s


@pytest.fixture
def stages():
    st = profiling.stages
    st.reset()
    yield st
    st.enabled = False
    st.reset()


def _bytes(t: torch.Tensor) -> bytes:
    return t.numpy().tobytes()


@pytest.mark.parametrize("garbage", [False, True],
                         ids=["reused-slab", "garbage-slab"])
@pytest.mark.parametrize("i", [0, 1, 2], ids=["first", "middle",
                                              "partial-last"])
def test_staged_tile_is_the_uploaded_slice(store, i, garbage):
    """Every leaf of a staged tile (`@qscale`, `gchroma` and `length`
    included) has the keys, shape, dtype, contiguity and bytes of
    `_upload(_tile_slice(...))`, for full tiles and the partial last one;
    slabs first filled with garbage, and slabs that last held a full
    tile, still give zeros in the pad rows."""
    st = harness._TileStager(store, TILE, "cpu")
    if garbage:
        for slab in st.slabs:
            slab.fill_(0xAB)
    else:
        # every slab of the ring once through a full tile first
        for _ in range(harness.STAGE_RING):
            st.block(0)
    got = st.block(i)
    want = harness._upload(harness._tile_slice(store, i * TILE,
                                               (i + 1) * TILE, TILE), "cpu")
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        assert (g.shape, g.dtype) == (w.shape, w.dtype), k
        assert g.is_contiguous(), k
        assert _bytes(g) == _bytes(w), k
    if i == 2:
        # one song of four: rows 1-3 are the pad
        assert all(not got[k][1:].any() for k in got)
        assert got["length"][0] > 0


def test_leaf_offsets_are_aligned_and_the_ring_bounds_the_slabs(store):
    st = harness._TileStager(store, TILE, "cpu")
    offs = [leaf[2] for leaf in st.leaves]
    assert offs == sorted(offs) and offs[0] == 0
    assert all(o % harness.STAGE_ALIGN == 0 for o in offs)
    assert st.nbytes % harness.STAGE_ALIGN == 0
    tile_bytes = sum(v.nbytes for v in
                     harness._tile_slice(store, 0, TILE, TILE).values())
    assert st.leaf_bytes == tile_bytes
    # the gaps between leaves are under one alignment step each
    assert tile_bytes <= st.nbytes < tile_bytes + harness.STAGE_ALIGN * len(
        st.leaves)
    assert len(st.slabs) == harness.STAGE_RING
    assert all(s.nbytes == st.nbytes for s in st.slabs)
    out = st.block(1)
    base = min(t.data_ptr() for t in out.values())
    assert all((t.data_ptr() - base) % harness.STAGE_ALIGN == 0
               for t in out.values())


def test_stager_counts_one_copy_a_fetch(store, stages):
    """One copy a fetch, of the leaves' bytes, once the tile leaves the
    host (the meta device stands in for the card, with no event to wait
    on); on the CPU, as `_upload` counts, none."""
    stages.enabled = True
    st = harness._TileStager(store, TILE, "meta")
    for i in (0, 1, 2, 0, 1, 2):
        assert all(t.device.type == "meta" for t in st.block(i).values())
    assert stages.counters == {"store:h2d_copies": 6,
                               "store:h2d_bytes": 6 * st.leaf_bytes,
                               "store:stage_waits": 0}
    assert stages.count["store:read"] == stages.count["store:h2d"] == 6
    stages.reset()
    stages.enabled = True
    st = harness._TileStager(store, TILE, "cpu")
    for i in (0, 1, 2):
        st.block(i)
    assert stages.counters == {"store:h2d_copies": 0, "store:h2d_bytes": 0}
    assert stages.count["store:read"] == stages.count["store:h2d"] == 3


def test_cpu_streamed_sweep_stages_every_tile(store, monkeypatch):
    """On a CPU device the streamed sweep fetches every tile as on a card,
    through the stager (one fetch a `sweep:tile` and one a `sweep:row`,
    never `_upload`), and its matrices are those of the device-resident
    sweep over the same store."""
    want = harness.run_pairwise(Serra09(), dict(store), 9, tile=TILE,
                                device_resident=True, device="cpu")
    fetched, real = [], harness._TileStager.block

    def block(self, i):
        fetched.append(i)
        return real(self, i)

    def refuse(*a, **k):
        raise AssertionError("the streamed sweep stages its tiles")

    monkeypatch.setattr(harness._TileStager, "block", block)
    monkeypatch.setattr(harness, "_upload", refuse)
    got = harness.run_pairwise(Serra09(), store, 9, tile=TILE,
                               device_resident=False, device="cpu")
    # three block-rows: 1 + 2 + 3 column tiles and 3 row tiles
    assert sorted(fetched) == [0, 0, 0, 0, 1, 1, 1, 2, 2]
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
