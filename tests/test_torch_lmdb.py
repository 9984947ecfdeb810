"""The port's LMDB layer against the JAX package's: writer bytes, readers
(Python and C++), the OC20 record decoder, export and conversion to shards.

Every comparison here is exact (bytes, or arrays bit for bit).  The JAX
package is reached only through its pure-Python reader, writer and decoder:
its native library is never built from here.
"""
import os
import pickle
import struct
import subprocess
import sys
import types

import numpy as np
import pytest

from adsorbdiff_tpu.data import lmdbio as jax_lmdbio
from adsorbdiff_tpu.data.lmdb_compat import _data_to_system as jax_data_to_system
from adsorbdiff_tpu.data.lmdb_compat import loads_pyg as jax_loads_pyg
from adsorbdiff_tpu.data.schema import System as JaxSystem
from adsorbdiff_tpu.data.store import write_shard as jax_write_shard
from adsorbdiff_tpu_torch.data import lmdb_compat, lmdb_native, lmdbio
from adsorbdiff_tpu_torch.data.lmdb_native import NativeLmdbReader, open_best_reader
from adsorbdiff_tpu_torch.data.schema import System
from tests.port_bridge import one_torch_thread  # noqa: F401  (autouse)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "oc20_2sys.lmdb")
FIELDS = ("pos", "atomic_numbers", "tags", "fixed", "cell", "sid", "fid", "energy", "y_relaxed", "pos_relaxed",
          "forces")


def _items(case):
    """(items, page size) of each writer case, from a numpy seed."""
    rng = np.random.default_rng(0)

    def blob(n):
        return bytes(rng.integers(0, 256, int(n), dtype=np.uint8))

    if case == "many":  # several leaves under a branch page, values from empty to multi-page overflow chains
        items = {f"{i:04d}".encode(): blob(rng.choice([0, 5, 100, 1500])) for i in range(300)}
        items[b"big-single"] = blob(3000)
        items[b"big-multi"] = blob(40000)
        return sorted(items.items()), 4096
    if case == "empty":
        return [], 4096
    if case == "single":
        return [(b"k", b"v")], 4096
    if case == "multilevel":  # thousands of keys at 512-byte pages: three levels and more
        return [(f"{i:06d}".encode(), (f"v{i}" * (i % 7 + 1)).encode()) for i in range(5000)], 512
    if case == "overflow":  # every value past half a page, at 8 KiB pages
        return [(str(i).encode(), blob(4100 + 977 * i)) for i in range(12)], 8192
    raise ValueError(case)


WRITER_CASES = ("many", "empty", "single", "multilevel", "overflow")


@pytest.mark.parametrize("case", WRITER_CASES)
def test_writer_bytes_equal_jax(tmp_path, case):
    items, psize = _items(case)
    ours, theirs = str(tmp_path / "port.lmdb"), str(tmp_path / "jax.lmdb")
    lmdbio.write_lmdb(ours, items, psize=psize)
    jax_lmdbio.write_lmdb(theirs, items, psize=psize)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    if case == "multilevel":
        with lmdbio.LmdbReader(ours) as r:
            assert r.meta["main"]["depth"] >= 3


@pytest.mark.parametrize("case", WRITER_CASES)
def test_readers_read_each_others_files(tmp_path, case):
    """Each package's reader on the other's file: every item in key order,
    point lookups, a missing key, the page size and entry count."""
    items, psize = _items(case)
    want = sorted(items)
    for write, read in ((lmdbio.write_lmdb, jax_lmdbio.LmdbReader), (jax_lmdbio.write_lmdb, lmdbio.LmdbReader)):
        path = str(tmp_path / f"{read.__module__}.lmdb")
        write(path, items, psize=psize)
        with read(path) as r:
            assert r.psize == psize and r.entries == len(items)
            assert list(r.items()) == want
            assert list(r.keys()) == [k for k, _ in want]
            for k, v in want[:: max(1, len(want) // 7)]:
                assert r.get(k) == v
            assert r.get(b"missing") is None


@pytest.mark.parametrize("case", ("fixture",) + WRITER_CASES)
def test_native_reader_equals_python_reader(tmp_path, case):
    if case == "fixture":
        path = FIXTURE
    else:
        items, psize = _items(case)
        path = str(tmp_path / "x.lmdb")
        lmdbio.write_lmdb(path, items, psize=psize)
    with lmdbio.LmdbReader(path) as py, NativeLmdbReader(path, chunk_records=97) as nat:
        want = list(py.items())
        assert nat.backend == "native" and nat.psize == py.psize and nat.entries == len(want)
        assert list(nat.items()) == want
        assert list(nat.keys()) == [k for k, _ in want]
        for k, v in want[:: max(1, len(want) // 11)]:
            assert nat.get(k) == v
        assert nat.get(b"missing") is None


def test_open_best_reader_honours_no_native(monkeypatch):
    with open_best_reader(FIXTURE) as r:
        assert r.backend == "native"
    monkeypatch.setattr(lmdb_native, "_LIB", None)
    monkeypatch.setenv("ADSORBDIFF_TPU_NO_NATIVE", "1")
    with open_best_reader(FIXTURE) as r:
        assert r.backend == "python" and isinstance(r, lmdbio.LmdbReader)
    with pytest.raises(OSError, match="ADSORBDIFF_TPU_NO_NATIVE"):
        NativeLmdbReader(FIXTURE)


def assert_same_system(got, want):
    """Every field equal bit for bit, with the same dtypes (None where None)."""
    for name in FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        if w is None or np.isscalar(w) or isinstance(w, (int, float)):
            assert g == w and type(g) is type(w), name
        else:
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)


def jax_systems(path):
    """JAX's decode of a file, through its pure-Python reader."""
    with jax_lmdbio.LmdbReader(path) as r:
        keys = sorted((int(k), k) for k in r.keys() if k.isdigit())
        return [jax_data_to_system(jax_loads_pyg(r.get(k))) for _, k in keys]


def test_fixture_systems_equal_jax():
    got = list(lmdb_compat.iter_lmdb_systems(FIXTURE))
    want = jax_systems(FIXTURE)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert_same_system(g, w)
    # the field map: float numbers to int32, [1, 3, 3] cell to [3, 3], float fixed to bool, force to forces
    assert got[0].atomic_numbers.dtype == np.int32 and got[0].cell.shape == (3, 3)
    assert got[0].fixed.dtype == bool and got[0].forces is not None
    assert got[1].forces is None and got[1].energy is None and not got[1].fixed.any()


def _pyg2_record():
    """A PyG >= 2 style pickle: a Data whose fields sit in its _store's
    _mapping, the classes under their torch_geometric module paths."""
    import torch

    saved = {k: v for k, v in sys.modules.items() if k.startswith("torch_geometric")}
    names = ("torch_geometric", "torch_geometric.data", "torch_geometric.data.data", "torch_geometric.data.storage")
    mods = {n: types.ModuleType(n) for n in names}

    class Data:
        pass

    class GlobalStorage:
        pass

    Data.__module__, GlobalStorage.__module__ = "torch_geometric.data.data", "torch_geometric.data.storage"
    Data.__qualname__, GlobalStorage.__qualname__ = "Data", "GlobalStorage"
    mods["torch_geometric.data.data"].Data = Data
    mods["torch_geometric.data.storage"].GlobalStorage = GlobalStorage
    sys.modules.update(mods)
    try:
        rng = np.random.default_rng(3)
        n = 7
        store = GlobalStorage()
        store._mapping = dict(
            pos=torch.from_numpy(rng.random((n, 3)).astype(np.float32)),
            atomic_numbers=torch.from_numpy(rng.integers(1, 80, n).astype(np.float32)),
            cell=torch.from_numpy(np.diag([7.0, 8.0, 25.0]).astype(np.float32))[None],
            tags=torch.from_numpy(rng.integers(0, 3, n).astype(np.int64)),
            fixed=torch.from_numpy((rng.random(n) < 0.5).astype(np.float32)),
            force=torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)),
            sid=torch.tensor([77]), fid=3, y=0.0, y_relaxed=-1.25,
        )
        d = Data()
        d._store = store
        return pickle.dumps(d, protocol=2)
    finally:
        for n in names:
            sys.modules.pop(n, None)
        sys.modules.update(saved)


def test_pyg2_store_pickles_decode_as_jax():
    raw = _pyg2_record()
    obj = lmdb_compat.loads_pyg(raw)
    with pytest.raises(AttributeError):
        obj.not_there
    got, want = lmdb_compat._data_to_system(obj), jax_data_to_system(jax_loads_pyg(raw))
    assert_same_system(got, want)
    assert got.sid == 77 and got.energy == 0.0 and got.forces.shape == (7, 3)


def port_and_jax_systems(rng, sizes):
    """The same random systems as the port's and JAX's System."""
    port, jax = [], []
    for i, n in enumerate(sizes):
        kw = dict(pos=rng.random((n, 3)).astype(np.float32) * 8, atomic_numbers=rng.integers(1, 80, n),
                  cell=np.diag(rng.uniform(6, 12, 3)).astype(np.float32), tags=rng.integers(0, 3, n),
                  fixed=rng.integers(0, 2, n).astype(bool), sid=100 + i, fid=i, energy=float(rng.normal()),
                  y_relaxed=float(rng.normal()), pos_relaxed=rng.random((n, 3)).astype(np.float32),
                  forces=rng.normal(0, 1, (n, 3)).astype(np.float32))
        port.append(System(**kw))
        jax.append(JaxSystem(**kw))
    return port, jax


def test_export_keeps_zero_and_missing_energies_and_forces(tmp_path):
    rng = np.random.default_rng(5)
    systems, _ = port_and_jax_systems(rng, [14, 9, 5])
    systems[0].energy = 0.0  # a legitimate zero must export
    systems[1].energy = None  # an unset one must stay unset
    systems[1].forces = None
    path = str(tmp_path / "export.lmdb")
    assert lmdb_compat.export_systems_to_lmdb(systems, path) == 3
    back = list(lmdb_compat.iter_lmdb_systems(path))
    assert [s.energy for s in back] == [0.0, None, systems[2].energy]
    assert back[1].forces is None and back[0].forces is not None
    for got, orig, theirs in zip(back, systems, jax_systems(path)):
        assert_same_system(got, theirs)
        for name in ("pos", "atomic_numbers", "tags", "fixed", "cell", "pos_relaxed"):
            np.testing.assert_array_equal(getattr(got, name), getattr(orig, name), err_msg=name)
        assert (got.sid, got.fid, got.y_relaxed) == (orig.sid, orig.fid, orig.y_relaxed)
    with lmdbio.LmdbReader(path) as r:
        assert b"torch_geometric.data.data" in r.get(b"0")  # the reference stack's import path
        assert pickle.loads(r.get(b"length")) == 3
    assert not any(k.startswith("torch_geometric") for k in sys.modules)


def test_fake_pyg_modules_leave_on_an_error():
    with pytest.raises(RuntimeError, match="inside"):
        with lmdb_compat._fake_pyg_modules() as Data:
            assert Data.__module__ == "torch_geometric.data.data" and "torch_geometric" in sys.modules
            raise RuntimeError("inside")
    assert not any(k.startswith("torch_geometric") for k in sys.modules)


def test_records_stream_in_numeric_key_order(tmp_path):
    """Keys b"0".."11" (b"10" sorts before b"2" as bytes) and metadata keys:
    the systems come in numeric order and the metadata is dropped."""
    rng = np.random.default_rng(7)
    systems, _ = port_and_jax_systems(rng, [4] * 12)
    path = str(tmp_path / "order.lmdb")
    lmdb_compat.export_systems_to_lmdb(systems, path)
    with lmdbio.LmdbReader(path) as r:
        items = list(r.items()) + [(b"metadata", pickle.dumps({"a": 1}))]
    lmdbio.write_lmdb(path, items)
    assert [s.sid for s in lmdb_compat.iter_lmdb_systems(path)] == [s.sid for s in systems]
    # a directory of files reads them in name order
    os.makedirs(tmp_path / "dir")
    lmdb_compat.export_systems_to_lmdb(systems[:3], str(tmp_path / "dir" / "b.lmdb"))
    lmdb_compat.export_systems_to_lmdb(systems[3:5], str(tmp_path / "dir" / "a.lmdb"))
    assert [s.sid for s in lmdb_compat.iter_lmdb_systems(str(tmp_path / "dir"))] == [
        s.sid for s in systems[3:5] + systems[:3]]


def test_convert_to_shards_columns_equal_jax(tmp_path):
    """convert_lmdb_to_shards against JAX's write_shard of JAX's decode of
    the same file: the same shards, every column equal with its dtype."""
    rng = np.random.default_rng(11)
    systems, _ = port_and_jax_systems(rng, rng.integers(3, 40, 7).tolist())
    src = str(tmp_path / "src.lmdb")
    lmdb_compat.export_systems_to_lmdb(systems, src)
    assert lmdb_compat.convert_lmdb_to_shards(src, str(tmp_path / "port"), shard_size=3) == 7
    want = jax_systems(src)
    for i, part in enumerate((want[:3], want[3:6], want[6:])):
        jax_write_shard(str(tmp_path / f"jax_{i:05d}"), part)
        got = np.load(str(tmp_path / f"port_{i:05d}.adshard.npz"))
        ref = np.load(str(tmp_path / f"jax_{i:05d}.adshard.npz"))
        assert sorted(got.files) == sorted(ref.files)
        for k in ref.files:
            assert got[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert not os.path.exists(str(tmp_path / "port_00003.adshard.npz"))


def test_meta_page_holds_the_page_size(tmp_path):
    """liblmdb reads the page size from the free DB's md_pad slot of each
    meta page (byte 40 of the page)."""
    for psize in (4096, 8192):
        path = str(tmp_path / f"meta{psize}.lmdb")
        lmdbio.write_lmdb(path, [(b"k", b"v")], psize=psize)
        with open(path, "rb") as f:
            raw = f.read(2 * psize)
        assert [struct.unpack_from("<I", raw, p * psize + 40)[0] for p in (0, 1)] == [psize, psize]


def test_host_libraries_build_in_parallel_processes(tmp_path):
    """Six processes build both host libraries into one empty directory at
    once; each then loads them and reads the fixture through the C++ reader."""
    code = (
        "import sys\n"
        "from adsorbdiff_tpu_torch.ops import host_build\n"
        "host_build.BUILD_DIR = sys.argv[1]\n"
        "from adsorbdiff_tpu_torch.data.lmdb_native import NativeLmdbReader\n"
        "from adsorbdiff_tpu_torch.data import native\n"
        "native._load_lib()\n"
        "with NativeLmdbReader(sys.argv[2]) as r:\n"
        "    print(r.entries, len(list(r.items())))\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("ADSORBDIFF_TPU_NO_NATIVE", None)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path), FIXTURE], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env) for _ in range(6)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0] * 6, [e for _, e in outs]
    assert [o.strip() for o, _ in outs] == ["3 3"] * 6
    built = sorted(os.listdir(tmp_path))
    assert len(built) == 2 and all(f.startswith(("liblmdbread-", "libadshard-")) and f.endswith(".so")
                                   for f in built), built
