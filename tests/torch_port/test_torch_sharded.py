"""The port's multi-device codec (``ec/sharded.py``) against the JAX package's.

The JAX side runs ``seaweedfs_tpu.ec.sharded`` on the 8-device virtual CPU
mesh (``tests/conftest.py``); the port runs meshes of repeated CPU devices,
where ``gf_matmul`` takes its plain version. Every split (dp, sp, and tp with
its masked bit slices) runs all the same, so bytes must be equal to the JAX
``MeshCodec`` and to ``NumpyCodec`` (GF(2^8) is exact: tolerance 0).
"""

import glob
import os
import shutil

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ec import encoder as jencoder
from seaweedfs_tpu.ec import sharded as jsharded
from seaweedfs_tpu.ec.codec import NumpyCodec
from seaweedfs_tpu_torch.ec import encoder as pencoder
from seaweedfs_tpu_torch.ec import mesh_dryrun
from seaweedfs_tpu_torch.ec import sharded as psharded
from seaweedfs_tpu_torch.ec.codec import Codec, get_codec
from seaweedfs_tpu_torch.ec.constants import shard_ext
from seaweedfs_tpu_torch.ec.gf_matmul import gf_matmul, gf_matmul_plain

MESHES = [(n, tp) for n in (1, 2, 4, 8) for tp in (1, 2, 4) if n % tp == 0]
WIDTHS = (1, 13, 1000, 4096, 8192 + 13)
LOST = [0, 3, 10, 13]


def cpu_mesh_codec(n, tp, k=10, m=4, **kw):
    return psharded.MeshCodec(k, m, devices=["cpu"] * n, tp=tp, **kw)


@pytest.mark.parametrize("n, tp", [(1, 1), (2, 1), (4, 1), (8, 1), (6, 1), (12, 1),
                                   (2, 2), (4, 2), (8, 2), (8, 4), (4, 4), (3, 2), (6, 4)])
def test_factor_mesh_matches_reference(n, tp):
    try:
        want = jsharded.factor_mesh(n, tp)
    except ValueError:
        with pytest.raises(ValueError):
            psharded.factor_mesh(n, tp)
        return
    assert psharded.factor_mesh(n, tp) == want


@pytest.mark.parametrize("n, tp", MESHES)
def test_mesh_codec_matches_jax_mesh_codec(n, tp):
    """Encode at odd widths and reconstruct, on a mesh of n devices with the
    contraction split tp ways, against the JAX MeshCodec on the same mesh
    shape and against NumpyCodec."""
    jmc = jsharded.MeshCodec(mesh=jsharded.build_mesh(n, tp=tp), chunk_bytes=4096)
    pmc = cpu_mesh_codec(n, tp)
    assert pmc.mesh.shape == dict(jmc.mesh.shape)
    assert pmc.alignment() == n // tp
    ref = NumpyCodec()
    rng = np.random.default_rng(100 * n + tp)
    for w in WIDTHS:
        d = rng.integers(0, 256, (10, w), dtype=np.uint8)
        want = ref.encode(d)
        assert np.array_equal(jmc.encode(d), want), w
        assert np.array_equal(pmc.encode(d), want), w
    full = ref.encode_shards(rng.integers(0, 256, (10, 2048 + 5), dtype=np.uint8))
    shards = [None if i in LOST else full[i].copy() for i in range(14)]
    pmc.reconstruct(shards)
    assert all(np.array_equal(shards[i], full[i]) for i in range(14))


@pytest.mark.parametrize("k, m", [(6, 3), (12, 4)])
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_alt_geometries(k, m, tp):
    """RS(6,3) and RS(12,4) (tests/test_ec_codec.py's alt geometries): tp=4
    cuts data rows in half by bits (48 / 4 = 12 bits a rank)."""
    rng = np.random.default_rng(9)
    d = rng.integers(0, 256, (k, 4096 + 777), dtype=np.uint8)
    want = NumpyCodec(k, m).encode(d)
    jmc = jsharded.MeshCodec(k, m, mesh=jsharded.build_mesh(4), chunk_bytes=64 * 1024)
    assert np.array_equal(jmc.encode(d), want)
    pmc = cpu_mesh_codec(4, tp, k, m)
    assert np.array_equal(pmc.encode(d), want)
    shards = list(NumpyCodec(k, m).encode_shards(d))
    shards[0] = shards[k] = None
    pmc.reconstruct(shards)
    assert np.array_equal(shards[0], d[0]) and np.array_equal(shards[k], want[0])


def test_tp_plan_masks_partial_rows():
    """tp=4 over k=10: each rank owns 20 bits, so row 2 splits 4/4 and row 7
    splits 4/4 between neighbours; the masks partition every row's bits."""
    pmc = cpu_mesh_codec(4, 4)
    plan = pmc._tp_plan(pmc.parity_rows)
    assert [(d0, d1) for _, d0, d1, _ in plan] == [(0, 3), (2, 5), (5, 8), (7, 10)]
    total = np.zeros(10, dtype=np.int64)
    for _, d0, d1, mask in plan:
        total[d0:d1] += 0xFF if mask is None else mask
    assert (total == 0xFF).all()
    assert plan[0][3].tolist() == [0xFF, 0xFF, 0x0F] and plan[1][3].tolist() == [0xF0, 0xFF, 0xFF]
    assert all(mask is None for _, _, _, mask in cpu_mesh_codec(4, 2)._tp_plan(pmc.parity_rows))


@pytest.mark.parametrize("n, tp", [(1, 1), (2, 1), (4, 1), (8, 1), (4, 2), (8, 2), (8, 4)])
def test_make_sharded_encode_matches_jax(n, tp):
    jmesh = jsharded.build_mesh(n, tp=tp)
    pmesh = psharded.build_mesh(devices=["cpu"] * n, tp=tp)
    parity_rows = NumpyCodec().parity_rows
    dp, sp = pmesh.shape["dp"], pmesh.shape["sp"]
    rng = np.random.default_rng(5 + n)
    data = rng.integers(0, 256, (2 * dp, 10, 512 * sp), dtype=np.uint8)
    want = np.asarray(jsharded.make_sharded_encode(jmesh, parity_rows)(data))
    got = psharded.make_sharded_encode(pmesh, parity_rows)(data)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), want)
    # a tensor batch at a ragged width
    t = torch.from_numpy(rng.integers(0, 256, (dp, 10, 777), dtype=np.uint8))
    got = psharded.make_sharded_encode(pmesh, parity_rows)(t)
    for b in range(dp):
        assert np.array_equal(got[b].numpy(), NumpyCodec().encode(t[b].numpy()))


# "cpu" and "cpu:0" are distinct mesh devices, so a CPU mesh can interleave
# its devices as a mesh of distinct cards would: column shards whose home
# devices alternate, and tp ranks on another device than their shard's home
# (the copy-and-XOR combine)
INTERLEAVED = [(["cpu", "cpu:0"] * 2, 1),
               (["cpu", "cpu:0"] * 2, 2),
               (["cpu", "cpu:0", "cpu:0", "cpu"] * 2, 2),
               (["cpu", "cpu:0"] * 4, 1)]


@pytest.mark.parametrize("devices, tp", INTERLEAVED)
def test_interleaved_devices_keep_their_own_columns(devices, tp):
    """Each span covers exactly its own column shards' columns, so no block
    reaches into another device's columns; the host fetch (``to_host``) and
    a fill of ``out`` equal NumpyCodec at odd widths."""
    mc = psharded.MeshCodec(devices=devices, tp=tp, chunk_bytes=4096)
    rng = np.random.default_rng(len(devices) + tp)
    for w in (1, 77, 4096 + 13, 3 * 8192 + 5):
        ranges = mc._col_ranges(w)
        for outputs in (True, False):
            spans = mc._spans(w, outputs)
            for d, c0, c1, shards in spans:
                assert shards == list(range(shards[0], shards[-1] + 1))
                assert (c0, c1) == (ranges[shards[0]][0], ranges[shards[-1]][1])
                assert all(d in mc._cols[i][:1 if outputs else None] for i in shards)
            if outputs:
                cover = sorted((c0, c1) for _, c0, c1, _ in spans)
                assert all(a[1] == b[0] for a, b in zip(cover, cover[1:]))
        d = rng.integers(0, 256, (10, w), dtype=np.uint8)
        want = NumpyCodec().encode(d)
        res = mc.matmul_device(mc.parity_rows, mc.device_put(d))
        got = mc.to_host(res, mc.record_ready(), mc.host_buffer(4 * w))
        assert np.array_equal(got, want), w
        out = torch.empty((4, w), dtype=torch.uint8)
        assert np.array_equal(mc.matmul_device(mc.parity_rows, torch.from_numpy(d), out=out).numpy(),
                              want), w


def test_make_sharded_encode_refuses_a_split_across_processes():
    """dp is the only axis that may cross a process, as in the reference."""
    devs = np.empty(4, dtype=object)
    devs[:] = [torch.device("cpu")] * 4
    spans = psharded.Mesh(devs.reshape(2, 2, 1), np.array([0, 1, 2, 3]).reshape(2, 2, 1))
    with pytest.raises(ValueError, match="dp slice 0 spans processes"):
        psharded.make_sharded_encode(spans, NumpyCodec().parity_rows, process_local=True)
    with pytest.raises(ValueError, match="spans processes"):
        psharded.make_sharded_encode(spans, NumpyCodec().parity_rows)
    with pytest.raises(ValueError, match="process-local"):
        psharded.MeshCodec(mesh=spans)
    with pytest.raises(ValueError):
        psharded.make_sharded_encode(psharded.build_mesh(devices=["cpu"] * 3, tp=3),
                                     NumpyCodec(7, 3).parity_rows)  # 56 bits over tp=3


def test_mesh_needs_the_card_unless_told_otherwise(monkeypatch):
    """``get_codec(device="mesh")`` and the default mesh use the local CUDA
    devices and never fall to the CPU; an explicit device list may repeat."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        get_codec(device="mesh")
    with pytest.raises(RuntimeError, match="CUDA"):
        psharded.build_mesh()
    mc = get_codec(device="mesh", devices=["cpu"] * 4, tp=2)
    assert isinstance(mc, psharded.MeshCodec) and mc.mesh.shape == {"dp": 2, "sp": 1, "tp": 2}
    assert isinstance(Codec.from_matrix(NumpyCodec().matrix, device="mesh",
                                        devices=["cpu"] * 2), psharded.MeshCodec)
    with pytest.raises(ValueError):
        psharded.build_mesh(n_devices=3, devices=["cpu"] * 2)


def test_gf_matmul_accumulate_xors_into_out():
    """``accumulate`` XORs the product into ``out``: partial products over a
    split contraction sum to the whole (the mesh's tp combine)."""
    rng = np.random.default_rng(3)
    matrix = rng.integers(0, 256, (4, 10), dtype=np.uint8)
    data = torch.from_numpy(rng.integers(0, 256, (10, 999), dtype=np.uint8))
    out = gf_matmul(np.ascontiguousarray(matrix[:, :4]), data[:4])
    gf_matmul(np.ascontiguousarray(matrix[:, 4:]), data[4:], out=out, accumulate=True)
    assert torch.equal(out, gf_matmul_plain(matrix, data))
    with pytest.raises(ValueError):
        gf_matmul(matrix, data, accumulate=True)


def _write_dat(path, n, seed):
    with open(path, "wb") as f:
        f.write(np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes())


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_write_and_rebuild_ec_files_match_jax_shards(tmp_path, tp):
    """The file path on a 4-device mesh: the shard files the overlap
    pipeline writes, and those it rebuilds with {0, 3, 10, 13} lost, equal
    the JAX package's (its MeshCodec on the virtual mesh)."""
    jb, pb = str(tmp_path / "j" / "1"), str(tmp_path / "p" / "1")
    os.makedirs(os.path.dirname(jb))
    os.makedirs(os.path.dirname(pb))
    _write_dat(jb + ".dat", 50_001, tp)
    shutil.copy(jb + ".dat", pb + ".dat")
    jencoder.write_ec_files(jb, jsharded.MeshCodec(n_devices=4, chunk_bytes=4096),
                            large_block_size=8192, small_block_size=512)
    pmc = cpu_mesh_codec(4, tp, chunk_bytes=4096)
    stats: dict = {}
    pencoder.write_ec_files(pb, pmc, large_block_size=8192, small_block_size=512,
                            pipeline_stats=stats)
    jfiles = sorted(glob.glob(jb + ".ec[0-9][0-9]"))
    assert len(jfiles) == 14
    for jf in jfiles:
        with open(jf, "rb") as a, open(pb + jf[-5:], "rb") as b:
            assert a.read() == b.read(), jf[-5:]
    for s in LOST:
        os.remove(pb + shard_ext(s))
    assert pencoder.rebuild_ec_files(pb, pmc, chunk_bytes=1000) == LOST
    for s in LOST:
        with open(jb + shard_ext(s), "rb") as a, open(pb + shard_ext(s), "rb") as b:
            assert a.read() == b.read(), s


def test_degraded_reads_through_a_mesh_store(tmp_path):
    """A Store whose codec is the tp=2 mesh, 40 needles of 200-400 KB, shards
    {0, 4, 9, 12} lost and no remote reader (the reference's
    __graft_entry__.py:138-185): every needle reads back equal, and equal to
    the JAX Store's read through its own MeshCodec."""
    from seaweedfs_tpu.storage.needle import Needle as JNeedle
    from seaweedfs_tpu.storage.store import Store as JStore
    from seaweedfs_tpu_torch.storage.needle import Needle as PNeedle
    from seaweedfs_tpu_torch.storage.store import Store as PStore
    from seaweedfs_tpu_torch.storage.store import ec_encode_volume

    pdir, jdir = str(tmp_path / "p"), str(tmp_path / "j")
    store = PStore([pdir], ec_backend="cpu")
    store.add_volume(10)
    rng = np.random.default_rng(14)
    blobs = {}
    for i in range(1, 41):
        blobs[i] = rng.integers(0, 256, int(rng.integers(200_000, 400_000)),
                                dtype=np.uint8).tobytes()
        store.write_volume_needle(10, PNeedle(cookie=7, id=i, data=blobs[i]))
    base = store.find_volume(10).file_name()
    store.close()
    mesh_codec = cpu_mesh_codec(4, 2, chunk_bytes=512 * 1024)
    ec_encode_volume(base, mesh_codec)
    for ext in (".dat", ".idx"):
        os.remove(base + ext)
    for sid in (0, 4, 9, 12):
        os.remove(base + shard_ext(sid))
    shutil.copytree(pdir, jdir)

    store = PStore([pdir], ec_backend="cpu")
    store._ec_codec = mesh_codec
    js = JStore([jdir], ec_backend="numpy")
    js._ec_codec = jsharded.MeshCodec(mesh=jsharded.build_mesh(4, tp=2), chunk_bytes=512 * 1024)
    try:
        assert store.remote_shard_reader is None
        assert len(store.find_ec_volume(10).shard_ids()) == 10
        for i, want in blobs.items():
            got = PNeedle(id=i)
            store.read_volume_needle(10, got)
            jgot = JNeedle(id=i)
            js.read_volume_needle(10, jgot)
            assert got.data == jgot.data == want, i
    finally:
        store.close()
        js.close()


def test_two_process_dry_run_matches_jax(tmp_path):
    """Two ranks over gloo, dp across the ranks and tp=2 inside each:
    ``make_sharded_encode(process_local=True)`` per rank, gathered on rank
    0, equal to the JAX MeshCodec's and NumpyCodec's parity."""
    got = mesh_dryrun.run(procs=2, devices=["cpu", "cpu"], tp=2, batch=2, width=4096 + 77,
                          seed=3, out_dir=str(tmp_path), timeout=120)
    assert got["mesh"] == {"dp": 2, "sp": 1, "tp": 2} and got["dp_slices"] == [[0], [1]]
    assert got["mismatches"] == 0
    data = np.load(tmp_path / "data.npy")
    parity = np.load(tmp_path / "parity.npy")
    assert parity.shape == (4, 4, 4096 + 77)
    jmc = jsharded.MeshCodec(mesh=jsharded.build_mesh(4, tp=2), chunk_bytes=64 * 1024)
    for b in range(4):
        want = NumpyCodec().encode(data[b])
        assert np.array_equal(parity[b], want), b
        assert np.array_equal(jmc.encode(data[b]), want), b


def test_four_process_dry_run():
    """World size 4, four devices a rank (dp=4 across the ranks, sp=4 in
    each): every rank's rows equal its own single-device codec's."""
    got = mesh_dryrun.run(procs=4, devices=["cpu"] * 4, tp=1, batch=1, width=1001,
                          timeout=120)
    assert got["mesh"] == {"dp": 4, "sp": 4, "tp": 1}
    assert got["dp_slices"] == [[0], [1], [2], [3]] and got["mismatches"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_mesh_codec_on_the_card(tp):
    """Repeated-card meshes launch the kernel (never the plain version) and
    equal CudaCodec; runs only where there is a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from seaweedfs_tpu_torch.ec import gf_matmul as gm

    mc = psharded.MeshCodec(devices=["cuda"] * 4, tp=tp)
    ref = get_codec()
    gen = torch.Generator(device="cuda").manual_seed(tp)
    data = torch.empty((10, 3 * 65536 + 5), dtype=torch.uint8, device="cuda").random_(
        0, 256, generator=gen)
    before = gm.gf_matmul.launches
    got = mc.matmul_device(ref.parity_rows, data, out=torch.empty(
        (4, data.shape[1]), dtype=torch.uint8, device="cuda"))
    assert gm.gf_matmul.launches > before
    assert torch.equal(got, ref.matmul_device(ref.parity_rows, data))
    host = np.random.default_rng(tp).integers(0, 256, (10, 70001), dtype=np.uint8)
    assert np.array_equal(mc.encode(host), NumpyCodec().encode(host))


@pytest.mark.cuda
@pytest.mark.parametrize("tp", [1, 2])
def test_mesh_codec_over_distinct_cards(tp):
    """Two cards, interleaved: with tp=1 the column shards' homes alternate,
    with tp=2 each shard's second rank runs on the other card and its
    partial bytes are copied to the home card and XORed there. Equal to
    CudaCodec and NumpyCodec; runs only where there are two cards."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    mc = psharded.MeshCodec(devices=["cuda:0", "cuda:1"] * 2, tp=tp)
    ref = get_codec(device="cuda:0")
    gen = torch.Generator(device="cuda:0").manual_seed(tp)
    data = torch.empty((10, 3 * 65536 + 5), dtype=torch.uint8, device="cuda:0").random_(
        0, 256, generator=gen)
    got = mc.matmul_device(ref.parity_rows, data, out=torch.empty(
        (4, data.shape[1]), dtype=torch.uint8, device="cuda:0"))
    assert torch.equal(got, ref.matmul_device(ref.parity_rows, data))
    host = np.random.default_rng(tp).integers(0, 256, (10, 70001), dtype=np.uint8)
    assert np.array_equal(mc.encode(host), NumpyCodec().encode(host))
