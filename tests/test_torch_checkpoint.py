"""Checkpoints of the torch port against the JAX package.

The port's ``utils/checkpoint.py`` writes the JAX package's format v1, so
the cases of ``tests/test_checkpoint.py`` run here on the port (round
trip, mutability after restore, the version gate, the client's save and
restore, a staged bulk build, autosave after a crash, the flat kind), and
a checkpoint of either package restores in the other with byte-equal
tables and identical replies. Integer-lattice data (and hamming words)
make every distance exact in f32, so replies compare exactly.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

import redis_hnsw_tpu as J
import redis_hnsw_tpu_torch as T
from redis_hnsw_tpu.utils import checkpoint as JC
from redis_hnsw_tpu_torch.utils import checkpoint as TC

BACKENDS = ["py", "native"]


def lattice(n, dim=4, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.integers(-6, 7, (n, dim)).astype(np.float32)
    data[:, 0] = np.arange(n) % 23  # few exact duplicates
    return data


def words(n, w=2, seed=0):
    return np.random.default_rng(seed).integers(
        0, 2**32, (n, w), dtype=np.uint32
    )


def read(path):
    with np.load(str(path), allow_pickle=False) as z:
        state = {key: z[key] for key in z.files}
    state["meta"] = json.loads(bytes(state["meta"].tobytes()).decode())
    return state


def assert_same_file(a, b):
    """Two checkpoints hold the same keys, in order, the same meta and
    byte-equal arrays of the same dtype and shape."""
    sa, sb = read(a), read(b)
    assert list(sa) == list(sb)
    assert sa["meta"] == sb["meta"]
    for key in sa:
        if key == "meta":
            continue
        assert sa[key].dtype == sb[key].dtype, key
        assert sa[key].shape == sb[key].shape, key
        assert sa[key].tobytes() == sb[key].tobytes(), key


def norm(reply):
    if isinstance(reply, list):
        return [norm(r) for r in reply]
    data = None if reply.data is None else reply.data.tolist()
    return (reply.sim, reply.name, data)


def make_pair(kind, metric, backend, n=160, name="ck"):
    """The same index built in both packages: (jax, port, data)."""
    dim = 64 if metric == "hamming" else 4
    data = words(n) if metric == "hamming" else lattice(n)
    kw = dict(dim=dim, m=4, ef_construction=24, metric=metric, seed=5,
              backend=backend)
    if kind == "flat":
        a = J.FlatIndex(name, J.IndexConfig(**kw))
        b = T.FlatIndex(name, T.IndexConfig(**kw), device="cpu")
    else:
        a = J.HNSWIndex(name, J.IndexConfig(**kw))
        b = T.HNSWIndex(name, T.IndexConfig(**kw), device="cpu")
    for x in (a, b):
        for i in range(n):
            x.add_node(f"n{i}", data[i])
        for i in range(0, n, 7):
            x.delete_node(f"n{i}")
    return a, b, data


def replies(idx, data, kind):
    qs = data[3::11]
    out = [norm(idx.search_knn(q, 5)) for q in qs[:3]]
    if kind == "flat":
        out.append(norm(idx.search_batch(qs, 6)))
    else:
        for engine in ("scan", "graph"):
            out.append(norm(idx.search_batch(qs, 6, engine=engine,
                                             ef_search=32, expand=2)))
    return out


CASES = [("hnsw", "euclidean"), ("hnsw", "hamming"), ("flat", "euclidean"),
         ("flat", "hamming")]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kind,metric", CASES)
def test_cross_package_checkpoints(tmp_path, kind, metric, backend):
    """A JAX checkpoint restores in the port and a port checkpoint in the
    JAX package: the files are byte-equal, both ways, and the restored
    indexes reply as the originals do."""
    a, b, data = make_pair(kind, metric, backend)
    pa, pb = tmp_path / "jax.npz", tmp_path / "port.npz"
    JC.save_index(a, str(pa))
    TC.save_index(b, str(pb))
    assert_same_file(pa, pb)
    b2 = TC.load_index(str(pa), device="cpu")   # JAX file -> port
    a2 = JC.load_index(str(pb))                 # port file -> JAX
    pa2, pb2 = tmp_path / "jax2.npz", tmp_path / "port2.npz"
    JC.save_index(a2, str(pa2))
    TC.save_index(b2, str(pb2))
    assert_same_file(pa, pa2)
    assert_same_file(pa, pb2)
    assert b2.device.type == "cpu"
    want = replies(a, data, kind)
    assert replies(b, data, kind) == want
    assert replies(b2, data, kind) == want
    assert replies(a2, data, kind) == want


def test_port_file_has_the_jax_layout(tmp_path):
    """The npz key set and the meta keys are the JAX file's: names as
    dtype "U" with "" on free rows, no backend in the config."""
    for kind in ("hnsw", "flat"):
        a, b, _ = make_pair(kind, "euclidean", "py", n=30)
        JC.save_index(a, str(tmp_path / "a.npz"))
        TC.save_index(b, str(tmp_path / "b.npz"), compress=False)
        sa, sb = read(tmp_path / "a.npz"), read(tmp_path / "b.npz")
        assert list(sb) == list(sa)
        assert list(sb["meta"]) == list(sa["meta"])
        assert list(sb["meta"]["config"]) == list(sa["meta"]["config"])
        assert "backend" not in sb["meta"]["config"]
        assert sb["names"].dtype.kind == "U"
        assert sb["names"][0] == ""  # n0 was deleted: the free-row sentinel
        assert not os.path.exists(str(tmp_path / "b.npz") + ".tmp")


@pytest.mark.parametrize("backend", BACKENDS)
def test_roundtrip_identical_graph(tmp_path, backend):
    _, idx, data = make_pair("hnsw", "euclidean", backend, n=200)
    path = str(tmp_path / "ck.npz")
    TC.save_index(idx, path)
    idx2 = TC.load_index(path, device="cpu")
    assert idx2.name == idx.name
    # the backend is the process's choice, not written: "auto" on load
    assert idx2.config == dataclasses.replace(idx.config, backend="auto")
    assert (idx2.node_count, idx2.max_layer, idx2.enterpoint) == (
        idx.node_count, idx.max_layer, idx.enterpoint)
    assert idx2._names._id_of == idx._names._id_of
    hw = idx._names.high_water
    np.testing.assert_array_equal(idx2._levels[:hw], idx._levels[:hw])
    assert [idx2._layer_lists(r) for r in range(hw)] == [
        idx._layer_lists(r) for r in range(hw)]
    assert idx2._layer_sets == idx._layer_sets
    assert replies(idx2, data, "hnsw") == replies(idx, data, "hnsw")


@pytest.mark.parametrize("backend", BACKENDS)
def test_restored_index_is_mutable(tmp_path, backend):
    a, b, data = make_pair("hnsw", "euclidean", backend, n=80)
    path = str(tmp_path / "ck.npz")
    TC.save_index(b, path)
    JC.save_index(a, str(tmp_path / "j.npz"))
    restored = [TC.load_index(path, device="cpu"),
                JC.load_index(str(tmp_path / "j.npz"))]
    for x in restored:
        x.add_node("extra", np.full(4, 0.5, np.float32))
        assert x.search_knn(np.full(4, 0.5, np.float32), 1)[0].name == "extra"
        x.add_node("n0", data[0])  # a name freed before the save
        x.delete_node("extra")
        assert "extra" not in x
    tb, ta = tmp_path / "tb.npz", tmp_path / "ta.npz"
    TC.save_index(restored[0], str(tb))
    JC.save_index(restored[1], str(ta))
    assert_same_file(ta, tb)


def test_version_gate(tmp_path):
    _, idx, _ = make_pair("hnsw", "euclidean", "py", n=20)
    path = str(tmp_path / "ck.npz")
    TC.save_index(idx, path)
    arrs = read(path)
    arrs["meta"]["format_version"] = 999
    arrs["meta"] = np.frombuffer(json.dumps(arrs["meta"]).encode(), np.uint8)
    np.savez(path, **arrs)
    with pytest.raises(T.HNSWError, match="format version 999"):
        TC.load_index(path, device="cpu")
    with pytest.raises(J.HNSWError, match="format version 999"):
        JC.load_index(path)


def test_client_save_restore(tmp_path):
    ca, cb = J.HNSW(), T.HNSW(device="cpu")
    for c in (ca, cb):
        c.create_index("a", dim=8, m=4, ef_construction=16, seed=0)
        for i in range(50):
            c.add_node("a", f"n{i}", np.full(8, float(i), np.float32))
    pa, pb = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    ca.save_index("a", pa)
    cb.save_index("a", pb)
    assert_same_file(pa, pb)
    cb.delete_index("a")
    cb.restore_index(pa)  # the JAX client's file
    assert cb.get_index("a") == ca.get_index("a")
    assert cb.search("a", np.full(8, 3.0, np.float32), k=1)[0].name == "n3"
    with pytest.raises(T.IndexExists):
        cb.restore_index(pb)
    idx = cb.restore_index(pb, name="b")
    assert idx.name == "b" and cb.list_indices() == ["a", "b"]
    assert idx.device.type == "cpu"
    q = np.full((2, 8), 7.25, np.float32)
    assert norm(cb.search_batch("b", q, k=3)[0]) == norm(
        ca.search_batch("a", q, k=3)[0])
    # a sharded directory of the JAX client restores in the port's
    ca.create_index("s", dim=8, m=4, ef_construction=16, seed=0,
                    kind="sharded")
    ca.add_batch("s", [f"n{i}" for i in range(50)],
                 np.arange(50, dtype=np.float32)[:, None].repeat(8, 1))
    ca.save_index("s", str(tmp_path / "sharded"))
    back = cb.restore_index(str(tmp_path / "sharded"))
    assert back.n_shards == 8 and back.node_count == 50
    assert {s.device.type for s in back.shards} == {"cpu"}
    assert norm(cb.search_batch("s", q, k=3)) == norm(
        ca.search_batch("s", q, k=3))
    assert cb.get_index("s") == ca.get_index("s")


@pytest.mark.parametrize("backend", BACKENDS)
def test_restore_then_continue_bulk_build(tmp_path, backend):
    """Staged builds (benchmarks/streaming1m.py's resume): bulk-build
    half, checkpoint, restore, bulk-build the rest -- the port's graph is
    the JAX package's, whichever package wrote the checkpoint."""
    n = 240
    data = lattice(n, dim=4, seed=3)
    names = [f"n{i}" for i in range(n)]
    kw = dict(dim=4, m=4, ef_construction=24, seed=9, backend=backend)
    a = J.HNSWIndex("st", J.IndexConfig(**kw))
    b = T.HNSWIndex("st", T.IndexConfig(**kw), device="cpu")
    for x in (a, b):
        x.add_batch(names[: n // 2], data[: n // 2], batch_size=48)
    pa, pb = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    JC.save_index(a, pa, compress=False)
    TC.save_index(b, pb, compress=False)
    assert_same_file(pa, pb)
    a2 = JC.load_index(pa)
    a2.add_batch(names[n // 2 :], data[n // 2 :], batch_size=48)
    JC.save_index(a2, str(tmp_path / "a2.npz"))
    for b2 in (TC.load_index(pa, device="cpu"),
               TC.load_index(pb, device="cpu")):
        b2.add_batch(names[n // 2 :], data[n // 2 :], batch_size=48)
        assert b2.node_count == n
        TC.save_index(b2, str(tmp_path / "b2.npz"))
        assert_same_file(tmp_path / "a2.npz", tmp_path / "b2.npz")


@pytest.mark.parametrize("backend", BACKENDS)
def test_autosave_crash_restore_continue(tmp_path, backend):
    """Autosave lands atomic checkpoints during a bulk build (a wave
    counts its inserts, a delete one op); after a "crash" the autosave
    restores to a consistent state, the build continues with the missing
    rows, and the node set matches a straight-through build. The JAX
    package's autosave writes the same files at the same points."""
    n = 200
    data = lattice(n, dim=4, seed=4)
    names = [f"n{i}" for i in range(n)]
    kw = dict(dim=4, m=4, ef_construction=24, seed=11, backend=backend)
    a = J.HNSWIndex("au", J.IndexConfig(**kw))
    b = T.HNSWIndex("au", T.IndexConfig(**kw), device="cpu")
    pa, pb = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    a.enable_autosave(pa, every_ops=40)
    b.enable_autosave(pb, every_ops=40)
    for x in (a, b):
        x.add_batch(names[:160], data[:160], batch_size=32)
        for i in range(5):
            x.delete_node(f"n{i}")
    assert os.path.exists(pb)
    assert_same_file(pa, pb)
    del b  # crash: what came after the last autosave is gone

    back = TC.load_index(pb, device="cpu")
    assert back.node_count <= 155
    have = set(back.node_names())
    missing = [m for m in names if m not in have and m not in
               {f"n{i}" for i in range(5)}]
    back.add_batch(missing, data[[names.index(m) for m in missing]],
                   batch_size=32)
    for i in range(5):
        if f"n{i}" in back:
            back.delete_node(f"n{i}")
    assert set(back.node_names()) == set(names) - {f"n{i}" for i in range(5)}
    for row in range(back._names.high_water):
        if back._levels[row] >= 0:
            assert back._nbrs(row, 0), row
    back.disable_autosave()
    stamp = os.path.getmtime(pb)
    back.add_node("late", data[0])
    assert os.path.getmtime(pb) == stamp


def test_flat_checkpoint_roundtrip(tmp_path):
    """kind=flat through the client: deletes (free-list holes), mutation
    after restore, and hamming, restoring byte-identically."""
    c = T.HNSW(device="cpu")
    rng = np.random.default_rng(0)
    c.create_index("f", dim=16, kind="flat")
    data = rng.standard_normal((60, 16)).astype(np.float32)
    c.add_batch("f", [f"n{i}" for i in range(60)], data)
    for i in range(0, 60, 3):
        c.delete_node("f", f"n{i}")
    ref = c.search_batch("f", data[:8], k=5)
    p = str(tmp_path / "f.npz")
    c.save_index("f", p)
    c.delete_index("f")
    idx = c.restore_index(p)
    assert isinstance(idx, T.FlatIndex) and idx.node_count == 40
    got = c.search_batch("f", data[:8], k=5)
    assert norm(ref) == norm(got)
    c.add_node("f", "fresh", data[0])
    assert c.search_batch("f", data[:1], k=1)[0][0].name == "fresh"

    c.create_index("hf", dim=256, metric="hamming", kind="flat")
    hd = rng.integers(0, 2**32, (30, 8), dtype=np.uint32)
    c.add_batch("hf", [f"h{i}" for i in range(30)], hd)
    href = c.search_batch("hf", hd[:4], k=3)
    hp = str(tmp_path / "hf.npz")
    c.save_index("hf", hp)
    c.delete_index("hf")
    c.restore_index(hp)
    assert norm(href) == norm(c.search_batch("hf", hd[:4], k=3))
