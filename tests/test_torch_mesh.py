"""The port's device-mesh sweeps (`acoss_tpu_torch.parallel.mesh`),
`parallel.initialize`, the CLI's `--mesh` and the dry run, on the CPU
against the JAX package: the same numpy descriptors go through JAX's
sweeps on the 8 virtual CPU devices of `tests/conftest.py` and through the
port's on a repeated CPU device. The port is within atol 1e-6 of JAX (the
tolerance of `test_torch_serra09.py`) and bit-equal to its own
`run_pairwise`."""

from tests import _torch_threads  # noqa: F401  (caps thread pools)

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from acoss_tpu import cli as jax_cli
from acoss_tpu.benchmarking.algorithms import Serra09 as JaxSerra09
from acoss_tpu.data import make_synthetic_dataset
from acoss_tpu.parallel import mesh as jax_mesh
from acoss_tpu_torch import cli, entry
from acoss_tpu_torch.benchmarking.algorithms import Serra09, Simple
from acoss_tpu_torch.benchmarking.harness import run_pairwise
from acoss_tpu_torch.data.descstore import quantize_int8
from acoss_tpu_torch.parallel import (initialize, make_pair_mesh,
                                      sharded_pair_scores,
                                      sharded_pair_scores_triangular)
from acoss_tpu_torch.parallel import mesh

REPO = Path(__file__).resolve().parent.parent
CPU8 = [torch.device("cpu")] * 8


def _algo():
    return Serra09(chroma_type="hpcp", downsample_fac=4)


@pytest.fixture(scope="module")
def corpus():
    """The JAX package's descriptors of `tests/test_parallel.py`'s corpus
    at the dry run's 4 s songs (14 songs, 64 descriptor rows) and the
    port's unsharded sweep of them (tile 8)."""
    jfs = make_synthetic_dataset(n_cliques=6, clique_size=2,
                                 n_distractors=2, seed=3, base_duration=4.0)
    desc = {k: np.asarray(v) for k, v in JaxSerra09(
        chroma_type="hpcp", downsample_fac=4).extract_descriptors(
            jfs).items()}
    full = run_pairwise(_algo(), desc, jfs.n_songs, tile=8, device="cpu")
    return jfs, desc, full


def _jax_tile(row, col):
    return JaxSerra09(chroma_type="hpcp", downsample_fac=4).tile_scores(
        row, col)


@pytest.mark.parametrize("case", ["2x4", "4x2", "1x8", "fold8", "fold4"])
def test_mesh_matches_jax_and_run_pairwise(corpus, case):
    """Rectangular meshes of 8 devices and the fold over 8 and 4: within
    1e-6 of the JAX package's sweep of the same descriptors, and equal to
    the port's run_pairwise bit for bit (its strict lower triangle for the
    rectangular sweep, which leaves the upper one in the other
    orientation; the whole matrix for the fold, in column tiles of 2 so
    that 8 devices' 16 chunks pad 14 songs to 32, not 64)."""
    jfs, desc, full = corpus
    n = jfs.n_songs
    fn = _algo().tile_scores
    if case.startswith("fold"):
        d = int(case[4:])
        got = sharded_pair_scores_triangular(fn, desc, n, devices=CPU8[:d],
                                             col_tile=2)
        want = jax_mesh.sharded_pair_scores_triangular(
            _jax_tile, desc, n, devices=jax.devices()[:d], col_tile=2)
        idx = ...
    else:
        shape = tuple(int(x) for x in case.split("x"))
        got = sharded_pair_scores(fn, desc, n, make_pair_mesh(CPU8, shape),
                                  col_tile=4)
        want = jax_mesh.sharded_pair_scores(
            _jax_tile, desc, n, jax_mesh.make_pair_mesh(shape=shape),
            col_tile=4)
        idx = np.tril_indices(n, -1)
    for k in full:
        assert got[k].dtype == np.float32 and got[k].shape == (n, n)
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0,
                                   atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(got[k][idx], full[k][idx], err_msg=k)


@pytest.mark.parametrize("quant", ["half", "int8"])
def test_quantized_descriptors(corpus, quant):
    """fp16 leaves through both sweeps within 5e-2 of the fp32 sweep;
    int8 leaves with @qscale companions equal to the sweep of the same
    values dequantized on the host."""
    jfs, desc, full = corpus
    n = jfs.n_songs
    fn = _algo().tile_scores
    m = make_pair_mesh(CPU8, (2, 4))
    if quant == "half":
        q = {k: v.astype(np.float16) if v.dtype == np.float32 else v
             for k, v in desc.items()}
        want, atol = full, 5e-2
    else:
        q = {}
        for k, v in desc.items():
            if v.dtype == np.float32 and v.ndim > 1:
                q[k], q[k + "@qscale"] = quantize_int8(v)
            else:
                q[k] = v
        deq = {k: (q[k].astype(np.float32) * q[k + "@qscale"].reshape(
            (-1,) + (1,) * (q[k].ndim - 1))) if k + "@qscale" in q else v
            for k, v in q.items() if not k.endswith("@qscale")}
        want = run_pairwise(_algo(), deq, n, tile=8, device="cpu")
        atol = 0.0
    rect = sharded_pair_scores(fn, q, n, m, col_tile=4)
    fold = sharded_pair_scores_triangular(fn, q, n, devices=CPU8, col_tile=2)
    tril = np.tril_indices(n, -1)
    for k in full:
        assert rect[k].dtype == np.float32
        np.testing.assert_allclose(rect[k][tril], want[k][tril], rtol=0,
                                   atol=atol, err_msg=k)
        np.testing.assert_allclose(fold[k], want[k], rtol=0, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("pairs", [4, 12])
def test_row_sub_blocks(corpus, monkeypatch, pairs):
    """A device block whose rows exceed MAX_PAIRS_PER_CALL // col_tile is
    split into sub-blocks (every call scores at most that many pairs), and
    the matrices equal the unsplit sweep's bit for bit."""
    jfs, desc, _ = corpus
    n = jfs.n_songs
    fn = _algo().tile_scores
    m = make_pair_mesh(CPU8[:2], (1, 2))
    one = sharded_pair_scores(fn, desc, n, m, col_tile=4)
    calls = []

    def counted(row, col):
        calls.append(row["length"].shape[0] * col["length"].shape[0])
        return fn(row, col)

    monkeypatch.setattr(mesh, "MAX_PAIRS_PER_CALL", pairs)
    split = sharded_pair_scores(counted, desc, n, m, col_tile=4)
    # 16 padded songs: two 16 x 8 blocks, 2 column tiles each, rows in
    # sub-blocks of max(1, pairs // 4)
    sub = max(1, pairs // 4)
    assert max(calls) <= max(pairs, 4)
    assert len(calls) == 2 * 2 * -(-16 // sub)
    for k in one:
        np.testing.assert_array_equal(split[k], one[k], err_msg=k)


SLOTS4 = [torch.device("cpu")] * 4


@pytest.fixture(scope="module")
def recorded(corpus):
    """The fold over 4 CPU slots (column tiles of 2: 16 padded songs,
    chunks of 2, one call a block) and the 2x2 rectangular sweep (column
    tiles of 2: blocks of 8 x 8, 4 calls each), each run once with the
    stage collector on and a `tile_scores_fn` that records which slot
    each call came from: a slot's rows are views of the copy restored for
    it alone, so the storage they view names the slot."""
    from acoss_tpu_torch.utils.profiling import stages

    jfs, desc, full = corpus
    n = jfs.n_songs
    fn = _algo().tile_scores
    out = {}
    for case in ("fold", "rect"):
        order, slots = [], {}

        def recording(row, col):
            ptr = row["chroma"].untyped_storage().data_ptr()
            order.append(slots.setdefault(ptr, len(slots)))
            return fn(row, col)

        stages.reset()
        stages.enabled = True
        try:
            if case == "fold":
                got = sharded_pair_scores_triangular(
                    recording, desc, n, devices=SLOTS4, col_tile=2)
            else:
                got = sharded_pair_scores(
                    recording, desc, n, make_pair_mesh(SLOTS4, (2, 2)),
                    col_tile=2)
        finally:
            stages.enabled = False
            counts = dict(stages.count)
            counters = dict(stages.counters)
            stages.reset()
        out[case] = (got, order, counts, counters)
    return full, out


@pytest.mark.parametrize("case", ["fold", "rect"])
def test_calls_alternate_between_slots(recorded, case):
    """The calls are enqueued round robin, one a slot a turn (every slot
    has as many calls here), and the matrices still equal run_pairwise's
    bit for bit (the whole matrix for the fold, the strict lower triangle
    for the rectangular sweep)."""
    full, out = recorded
    got, order, _, _ = out[case]
    per = {"fold": 9, "rect": 4}[case]
    assert order == [0, 1, 2, 3] * per
    n = full["chroma_qmax"].shape[0]
    idx = ... if case == "fold" else np.tril_indices(n, -1)
    for k in full:
        np.testing.assert_array_equal(got[k][idx], full[k][idx], err_msg=k)


@pytest.mark.parametrize("case", ["fold", "rect"])
def test_mesh_spans_and_counters(recorded, case):
    """With the stage collector on, every mesh span and counter is
    recorded: a call a `mesh:enqueue` and a `mesh:calls`, as many as the
    decomposition implies (fold: 4 slots x 9 blocks x 1 call; 2x2: 4
    blocks x 4 column tiles), a block a `mesh:gather` and `mesh:blocks`,
    a restore a slot (two for a rectangular block: its rows and its
    columns), one `mesh:fold`."""
    _, out = recorded
    _, _, counts, counters = out[case]
    calls, blocks, restores = {"fold": (36, 36, 4),
                               "rect": (16, 4, 8)}[case]
    assert counters["mesh:calls"] == counts["mesh:enqueue"] == calls
    assert counters["mesh:blocks"] == counts["mesh:gather"] == blocks
    assert counts["mesh:restore"] == restores
    assert counts["mesh:fold"] == 1


def test_fold_equals_the_benchmark_reference():
    """24 songs rendered by the benchmark's generator, folded over 4 CPU
    slots (column tiles of 2: chunks of 4 songs, 8 of them padding), equal
    the benchmark's plain reference (`portbench/reference/serra09.py`,
    which shares no code with the port) for every pair: its strict lower
    triangle, mirrored, with a zero diagonal."""
    sys.path.insert(0, str(REPO))
    from portbench import corpus as C
    from portbench.reference import serra09 as ref

    cfg = {"algorithm": "Serra09", "params": {
        "chroma_type": "hpcp", "oti": True, "kappa": 0.095, "m": 9,
        "downsample_fac": 40, "pad_to_multiple": 64, "do_ssms": False},
        "corpus": {"kind": "datacos", "n_cliques": 7, "clique_size": 3,
                   "n_distractors": 3, "n_states": 12,
                   "base_duration": 60.0, "beat_period": 30.0}}
    songs_of = C.Corpus(cfg, 7)
    n = songs_of.n_songs
    songs = songs_of.raw(np.arange(n))
    algo = C.algorithm(cfg)
    desc = algo.extract_descriptors(C.feature_set(songs, songs_of.labels),
                                    device="cpu")
    got = sharded_pair_scores_triangular(algo.tile_scores, desc, n,
                                         devices=SLOTS4, col_tile=2)
    d = ref.descriptors(songs, songs_of.width, torch.device("cpu"))
    for k, v in ref.serra09_tile(d, d).items():
        low = np.tril(v.numpy(), -1)
        assert got[k].shape == (n, n) == (24, 24)
        np.testing.assert_array_equal(got[k], low + low.T, err_msg=k)
        assert not np.diag(got[k]).any() and np.any(low)


@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
def test_fold_balance(n_devices):
    """Every device owns exactly 2D+1 blocks, and together they cover the
    lower-triangular block grid of 2D chunks once."""
    blocks = mesh.fold_blocks(n_devices)
    two_d = 2 * n_devices
    assert [len(b) for b in blocks] == [two_d + 1] * n_devices
    flat = sorted(x for b in blocks for x in b)
    assert flat == [(r, c) for r in range(two_d) for c in range(r + 1)]


@pytest.mark.parametrize("n,shape", [(8, (2, 4)), (4, (2, 2)), (6, (2, 3)),
                                     (7, (1, 7)), (1, (1, 1))])
def test_make_pair_mesh_default_shape(n, shape):
    """JAX's default shape: r <= c, r * c = n, r as large as divides."""
    got = make_pair_mesh([torch.device("cpu")] * n)
    assert got.shape == shape == jax_mesh.make_pair_mesh(
        jax.devices()[:n]).devices.shape


def test_mesh_without_a_card_raises():
    """No fallback: a mesh of CUDA devices on a host without one raises,
    and so does the CLI's --mesh with --device cuda."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_pair_mesh()
    with pytest.raises(RuntimeError, match="needs 4 CUDA devices"):
        mesh.mesh_devices("cuda", 4)
    with pytest.raises(ValueError, match="2 x 2"):
        make_pair_mesh(CPU8[:3], (2, 2))


@pytest.fixture(scope="module")
def cli_corpus(tmp_path_factory):
    """A FeatureSet of 8 songs long enough for Serra09's defaults (30 s:
    ~64 descriptor rows after the x40 downsampling)."""
    d = tmp_path_factory.mktemp("mesh_cli")
    jfs = make_synthetic_dataset(n_cliques=4, clique_size=2, seed=1,
                                 base_duration=30.0)
    jfs.save(str(d / "fs.npz"))
    return d


def _maps(out: str) -> list:
    """The CLI's report rows (not the sweep's own progress lines)."""
    return sorted(ln for ln in out.splitlines()
                  if "MAP=" in ln and not ln.startswith("["))


def test_cli_mesh_matches_jax_cli(cli_corpus, tmp_path, monkeypatch,
                                  capsys):
    """`benchmark --mesh 2x4 --device cpu` reports the JAX CLI's MAP rows
    (Serra09 takes the triangular fold over the flattened grid; column
    tiles of 2 keep the fold's padding small), and a --mesh of CUDA
    devices on a host without one raises."""
    monkeypatch.chdir(tmp_path)
    args = ["benchmark", "-a", "Serra09", "-d", str(cli_corpus / "fs.npz"),
            "-s", "m", "--mesh", "2x4", "-t", "2"]
    assert jax_cli.main(args) == 0
    want = _maps(capsys.readouterr().out)
    assert cli.main(args + ["--device", "cpu"]) == 0
    got = _maps(capsys.readouterr().out)
    assert got == want and len(got) == 4
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(args + ["--device", "cuda"])


def test_cli_mesh_rectangular_branch(cli_corpus, tmp_path, monkeypatch,
                                     capsys):
    """A non-symmetric algorithm (Simple) takes the rectangular sweep with
    the diagonal zeroed: the same MAP rows as the plain benchmark; a
    one-shot scorer and a malformed shape are refused."""
    monkeypatch.chdir(tmp_path)
    base = ["benchmark", "-d", str(cli_corpus / "fs.npz"), "-s", "r",
            "--device", "cpu", "--no-checkpoint"]
    assert cli.main(base + ["-a", "Simple", "--mesh", "2x2"]) == 0
    got = _maps(capsys.readouterr().out)
    assert cli.main(base + ["-a", "Simple"]) == 0
    assert got == _maps(capsys.readouterr().out) and len(got) == 1
    assert not Simple.SYMMETRIC
    assert cli.main(base + ["-a", "FTM2D", "--mesh", "2x2"]) == 1
    with pytest.raises(SystemExit):
        cli.main(base + ["-a", "Simple", "--mesh", "2by2"])


@pytest.mark.parametrize("n_devices", [8, 4])
def test_dryrun_multichip_on_cpu(n_devices, capsys):
    entry.dryrun_multichip(n_devices, device="cpu")
    out = capsys.readouterr().out
    assert out.startswith("dryrun_multichip OK: mesh ")
    assert "sharded==unsharded (exact)" in out


def test_entry_tile_on_cpu():
    fn, (row, col) = entry.entry(device="cpu")
    out = fn(row, col)
    assert sorted(out) == sorted(Serra09.SIMILARITY_TYPES)
    assert all(v.shape == (4, 4) and torch.isfinite(v).all()
               for v in out.values())


def test_initialize_single_process_is_a_no_op():
    import torch.distributed as dist

    initialize(num_processes=1)
    initialize("127.0.0.1:1", 1, 0, device="cpu")
    assert not dist.is_initialized()


_RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from acoss_tpu_torch.benchmarking.algorithms import Serra09
    from acoss_tpu_torch.parallel import (initialize, merge_partials,
                                          run_process_shard)

    torch.set_num_threads(1)
    addr, rank, nproc, out = sys.argv[1], int(sys.argv[2]), 4, sys.argv[3]
    initialize(addr, nproc, rank, device="cpu")
    assert dist.get_backend() == "gloo" and dist.get_world_size() == nproc
    with np.load(f"{out}/desc.npz") as z:
        desc = {k: z[k] for k in z.files}
    n = desc["length"].shape[0]
    algo = Serra09(chroma_type="hpcp", downsample_fac=4)
    run_process_shard(algo, desc, n, rank, nproc, f"{out}/parts", tile=4,
                      device="cpu")
    dist.barrier()
    if rank == 0:
        paths = [f"{out}/parts/Serra09_part_{p}_{nproc}.npz"
                 for p in range(nproc)]
        merged = merge_partials(paths, symmetric=True)
        np.savez(f"{out}/merged.npz", **merged)
    dist.barrier()
    dist.destroy_process_group()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_initialize_gloo_four_processes(corpus, tmp_path):
    """Four processes rendezvous through `initialize` over gloo, each
    sweeps its process shard, and after a barrier rank 0's merge equals
    the single-process sweep bit for bit. Each rank has its own 60 s
    limit, so a hung rendezvous fails instead of stalling the suite."""
    jfs, desc, _ = corpus
    n = jfs.n_songs
    np.savez(tmp_path / "desc.npz", **desc)
    want = run_pairwise(_algo(), desc, n, tile=4, device="cpu")
    addr = f"127.0.0.1:{_free_port()}"
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, addr, str(r), str(tmp_path)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(4)]
    try:
        errs = [p.communicate(timeout=60)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * 4, errs
    with np.load(tmp_path / "merged.npz") as z:
        for k in want:
            np.testing.assert_array_equal(z[k], want[k], err_msg=k)
