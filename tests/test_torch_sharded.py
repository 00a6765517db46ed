"""The port's ShardedHNSW against the JAX package's: meshes, shard
assignment, bulk builds, mutations, checkpoints, the client and the RESP
server.

Mirrors tests/test_sharded.py. The JAX ``ShardedHNSW`` runs on the
8-device virtual CPU mesh (tests/conftest.py), the port's on the CPU
repeated 8 times (``make_mesh(8, device="cpu")``); both get the same
seeded rows, names, seeds and ``batch_size``. On integer-lattice rows the
shard assignment and every shard's graph are byte-equal, interleaved
build or not, and a checkpoint directory of either package restores in
the other. Hamming replies are compared here too, their sims by value:
the port's scan replies a zero distance as -0.0 where the JAX package
gives +0.0. tests/test_torch_sharded_scan.py compares the replies.
"""

import os

import numpy as np
import pytest
import torch

import redis_hnsw_tpu as J
import redis_hnsw_tpu_torch as T
from redis_hnsw_tpu import server as JSV
from redis_hnsw_tpu.parallel import ShardedHNSW as JShard
from redis_hnsw_tpu.parallel import make_mesh as jmesh
from redis_hnsw_tpu.parallel.sharded import _shard_of as jax_shard_of
from redis_hnsw_tpu_torch import server as TSV
from redis_hnsw_tpu_torch.parallel import (
    DATA_AXIS,
    SLICE_AXIS,
    Mesh,
    ShardedHNSW,
    make_mesh,
    make_mesh2d,
)
from redis_hnsw_tpu_torch.parallel.sharded import _shard_of
from test_torch_server import RawClient, seeded, serve, stop


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side is many small per-shard ops: one intra-op thread
    keeps them cheap beside the JAX mesh's threads under a parallel test
    run (the previous count is restored)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def lattice(n, dim=8, seed=0):
    return np.random.default_rng(seed).integers(-4, 5, (n, dim)).astype(
        np.float32)


def cfg(pkg, **kw):
    return pkg.IndexConfig(**{**dict(dim=8, m=6, ef_construction=32,
                                     seed=3), **kw})


def graph_state(idx):
    """Everything a build decides, per shard: names by row, levels,
    max_layer, enterpoint and every row's neighbour lists by layer."""
    out = []
    for s in idx.shards:
        hw = s._names.high_water
        out.append((
            [s._names._name_of[r] for r in range(hw)],
            s._levels[:hw].tobytes(), s.max_layer, s.enterpoint,
            [s._layer_lists(r) for r in range(hw)],
        ))
    return out


def replies(idx, qs, k=6):
    return [idx.search_batch(qs, k, engine=e, reply="columnar")
            for e in ("scan", "graph")]


def same_replies(ra, rb):
    for (na, sa), (nb, sb) in zip(ra, rb):
        assert np.array_equal(na, nb)
        assert np.array_equal(sa.view(np.int32), sb.view(np.int32))


@pytest.fixture(scope="module")
def built():
    """A 500-row lattice index on each side, interleaved build."""
    data = lattice(500)
    names = [f"n{i}" for i in range(500)]
    a = JShard("sh", cfg(J), mesh=jmesh(8))
    b = ShardedHNSW("sh", cfg(T), mesh=make_mesh(8, device="cpu"))
    for idx in (a, b):
        idx.add_batch(names, data, batch_size=64)
    return a, b, data, names


# -- meshes ----------------------------------------------------------------------


def test_meshes():
    m = make_mesh(8, device="cpu")
    assert m.devices.shape == (8,) and m.axis_names == (DATA_AXIS,)
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    assert make_mesh(device="cpu").devices.size == 1
    m2 = make_mesh2d(2, 4, device="cpu")
    assert m2.devices.shape == (2, 4)
    assert m2.axis_names == (SLICE_AXIS, DATA_AXIS)
    assert m2.shape == {SLICE_AXIS: 2, DATA_AXIS: 4}
    # any explicit devices, repeats included, make a 1-D mesh
    idx = ShardedHNSW("x", cfg(T), mesh=["cpu"] * 3)
    assert idx.n_shards == 3 and idx.mesh.shape == {DATA_AXIS: 3}
    assert [s.device.type for s in idx.shards] == ["cpu"] * 3
    assert ShardedHNSW("y", cfg(T), mesh=Mesh(
        np.array([["cpu", "cpu"]] * 2, object), (SLICE_AXIS, DATA_AXIS)
    )).n_shards == 4
    with pytest.raises(ValueError):
        Mesh(["cpu"] * 4, (SLICE_AXIS, DATA_AXIS))


def test_cuda_mesh_never_falls_back(monkeypatch):
    """A CUDA mesh with too few cards raises, with no card at all too;
    no shard of a card client is placed on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="need 4 devices, have 2"):
        make_mesh(4)
    with pytest.raises(ValueError, match="need 4 devices, have 2"):
        make_mesh2d(2, 2, device="cuda")
    with pytest.raises(ValueError, match="need 3 devices, have 2"):
        ShardedHNSW("x", cfg(T), n_shards=3)
    m = make_mesh()
    assert [str(d) for d in m.devices.flat] == ["cuda:0", "cuda:1"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(T.HNSWError, match="no CUDA device"):
        make_mesh(1)
    with pytest.raises(T.HNSWError, match="no CUDA device"):
        T.HNSW(device="cuda")


# -- shard assignment and builds ------------------------------------------------------


def test_shard_assignment_equal(built):
    a, b, _, names = built
    assert [_shard_of(n, 8) for n in names] == [
        jax_shard_of(n, 8) for n in names]
    for sa, sb in zip(a.shards, b.shards):
        assert sa.node_names() == sb.node_names()
        assert sa.config.seed == sb.config.seed
    assert [s.config.seed for s in b.shards] == list(range(3, 11))


@pytest.mark.parametrize("interleave", [True, False])
@pytest.mark.parametrize("backend", ["py", "native"])
def test_graphs_byte_equal(built, interleave, backend):
    """Interleaved or plain, on either host backend, the port's per-shard
    graphs are the JAX package's interleaved build's, byte for byte."""
    a, _, data, names = built
    b = ShardedHNSW("sh", cfg(T, backend=backend),
                    mesh=make_mesh(8, device="cpu"))
    b.add_batch(names, data, batch_size=64, interleave=interleave)
    assert graph_state(b) == graph_state(a)


def test_jax_plain_build_equals_interleaved(built):
    a, b, data, names = built
    c = JShard("sh", cfg(J), mesh=jmesh(8))
    c.add_batch(names, data, batch_size=64, interleave=False)
    assert graph_state(c) == graph_state(a) == graph_state(b)


def test_2d_mesh_builds_the_same_graphs(built):
    _, b, data, names = built
    c = ShardedHNSW("sh", cfg(T), mesh=make_mesh2d(2, 4, device="cpu"))
    c.add_batch(names, data, batch_size=64)
    assert graph_state(c) == graph_state(b)


def test_add_node_build_equal():
    """Single inserts route to the owning shard on both sides."""
    data = lattice(90, seed=4)
    a = JShard("one", cfg(J), mesh=jmesh(8))
    b = ShardedHNSW("one", cfg(T), mesh=make_mesh(8, device="cpu"))
    for i, row in enumerate(data):
        a.add_node(f"p{i}", row)
        b.add_node(f"p{i}", row)
    assert graph_state(a) == graph_state(b)
    assert a.get_node("p5")["neighbors"] == b.get_node("p5")["neighbors"]
    assert len(b) == b.node_count == 90
    with pytest.raises(ValueError, match="names for"):
        b.add_batch(["x"], data[:2])


def test_hamming_replies_equal():
    """Hamming words over 8 shards: graphs byte-equal; the scan (kernel
    A′'s plain version over packed words) and the graph engine, with and
    without seeds, equal the JAX package's (the scan's sims by value:
    -0.0 against +0.0 at distance zero); a duplicated slab puts tie
    classes at the cut."""
    rng = np.random.default_rng(5)
    data = rng.integers(0, 2**32, (600, 8), dtype=np.uint32)
    data[300:340] = np.repeat(data[300:305], 8, axis=0)
    qs = np.concatenate([rng.integers(0, 2**32, (12, 8), dtype=np.uint32),
                         data[300:304]])
    names = [f"h{i}" for i in range(600)]
    cfg = dict(dim=256, m=8, ef_construction=48, metric="hamming", seed=2)
    a = JShard("h", J.IndexConfig(**cfg), mesh=jmesh(8))
    b = ShardedHNSW("h", T.IndexConfig(**cfg), mesh=make_mesh(8, device="cpu"))
    for idx in (a, b):
        idx.add_batch(names, data, batch_size=128)
    assert graph_state(a) == graph_state(b)
    for kw in (dict(engine="scan"), dict(engine="scan-approx"),
               dict(engine="graph", ef_search=64, expand=8, iters=12),
               dict(engine="graph", seeds=4, ef_search=32)):
        ra = a.search_batch(qs, 10, reply="columnar", **kw)
        rb = b.search_batch(qs, 10, reply="columnar", **kw)
        assert np.array_equal(ra[0], rb[0]), kw
        assert np.array_equal(ra[1], rb[1]), kw
        if kw["engine"] == "graph":
            assert np.array_equal(ra[1].view(np.int32), rb[1].view(np.int32))
    zero = b.search_batch(qs[12:], 1, engine="scan", reply="columnar")[1]
    assert (zero == 0).all() and np.signbit(zero).all()


# -- mutations and edge cases --------------------------------------------------------


def test_delete_batch_and_node():
    data = lattice(400, seed=5)
    names = [f"d{i}" for i in range(400)]
    a = JShard("del", cfg(J), mesh=jmesh(8))
    b = ShardedHNSW("del", cfg(T), mesh=make_mesh(8, device="cpu"))
    for idx in (a, b):
        idx.add_batch(names, data, batch_size=128)
    before = graph_state(b)
    victims = names[0:100:2]
    with pytest.raises(T.NodeNotFound):
        b.delete_batch(victims + ["ghost"])
    with pytest.raises(T.NodeNotFound):
        b.delete_batch(victims + victims[:1])  # a repeat is missing too
    assert graph_state(b) == before  # validate-first: no shard mutated
    for idx in (a, b):
        idx.delete_batch(victims)
        idx.delete_node("d1")
    assert b.node_count == 349
    assert graph_state(a) == graph_state(b)
    qs = data[:8] + 0.5
    same_replies(replies(a, qs), replies(b, qs))
    got = {n for row in replies(b, data[:8])[0][0] for n in row}
    assert not got & (set(victims) | {"d1"})


def test_empty_index_and_empty_batch():
    a = JShard("e", cfg(J), mesh=jmesh(8))
    b = ShardedHNSW("e", cfg(T), mesh=make_mesh(8, device="cpu"))
    q = np.zeros((2, 8), np.float32)
    assert a.search_batch(q, 3) == b.search_batch(q, 3) == [[], []]
    names, sims = b.search_batch(q, 3, reply="columnar")
    assert names.shape == (2, 3) and (names == None).all()  # noqa: E711
    assert np.isneginf(sims).all()
    for idx in (a, b):
        idx.add_node("solo", np.ones(8, np.float32))
    for engine in ("scan", "graph"):
        ra = a.search_batch(q, 3, engine=engine)
        assert [[(r.sim, r.name) for r in row] for row in ra] == [
            [(r.sim, r.name) for r in row]
            for row in b.search_batch(q, 3, engine=engine)]
        assert [r.name for r in ra[0]] == ["solo"]
    empty = np.zeros((0, 8), np.float32)
    assert b.search_batch(empty, 5) == []
    names, sims = b.search_batch(empty, 5, reply="columnar")
    assert names.shape == sims.shape == (0, 5)
    with pytest.raises(T.DimensionMismatch):
        b.search_batch(np.zeros((1, 4), np.float32), 3)


def test_fewer_rows_than_shards():
    data = lattice(3, seed=6)
    a = JShard("few", cfg(J), mesh=jmesh(8))
    b = ShardedHNSW("few", cfg(T), mesh=make_mesh(8, device="cpu"))
    for idx in (a, b):
        idx.add_batch(["f0", "f1", "f2"], data)
    assert sum(s.node_count == 0 for s in b.shards) >= 5
    qs = lattice(4, seed=7)
    for kw in (dict(engine="scan"), dict(engine="graph"),
               dict(engine="graph", seeds=2), dict(engine="auto")):
        ra = a.search_batch(qs, 5, reply="columnar", **kw)
        rb = b.search_batch(qs, 5, reply="columnar", **kw)
        assert np.array_equal(ra[0], rb[0]), kw
        assert np.array_equal(ra[1], rb[1]), kw
        assert (rb[0][:, 3:] == None).all()  # noqa: E711
    assert [r.name for r in b.search_knn(data[1], 5)][0] == "f1"


# -- checkpoints -------------------------------------------------------------------


def test_checkpoint_directories_cross_both_ways(built, tmp_path):
    """The port's directory restores in the JAX package and the JAX
    package's in the port: shard tables byte-equal, replies equal, and
    the restored index keeps building the same graphs."""
    a, b, data, _ = built
    qs = data[::37] + 0.25
    da, db = str(tmp_path / "jax"), str(tmp_path / "port")
    a.save(da)
    b.save(db, compress=False)
    assert sorted(os.listdir(da)) == sorted(os.listdir(db))
    with open(os.path.join(da, "manifest.json")) as fa, open(
            os.path.join(db, "manifest.json")) as fb:
        assert fa.read() == fb.read()
    into_port = ShardedHNSW.restore(da, device="cpu")
    into_jax = JShard.restore(db, mesh=jmesh(8))
    assert into_port.n_shards == 8 and into_port.name == "sh"
    assert all(s.device.type == "cpu" for s in into_port.shards)
    for x in (into_port, into_jax):
        assert graph_state(x) == graph_state(b)
    same_replies(replies(a, qs), replies(into_port, qs))
    same_replies(replies(b, qs), replies(into_jax, qs))
    more = lattice(40, seed=8)
    for x in (into_port, into_jax):
        x.add_batch([f"m{i}" for i in range(40)], more, batch_size=16)
    assert graph_state(into_port) == graph_state(into_jax)
    # carried across without a file: the JAX shards' states
    c = T.sharded_from_state(*T.sharded_state(into_jax),
                             mesh=make_mesh2d(2, 4, device="cpu"))
    assert graph_state(c) == graph_state(into_port)
    same_replies(replies(c, qs), replies(into_port, qs))


def test_checkpoint_gates(built, tmp_path):
    _, b, _, _ = built
    d = str(tmp_path / "ck")
    b.save(d)
    with pytest.raises(T.HNSWError, match="checkpoint has 8 shards"):
        ShardedHNSW.restore(d, mesh=make_mesh(4, device="cpu"))
    manifest, states = T.sharded_state(b)
    with pytest.raises(T.HNSWError, match="format version 2"):
        T.sharded_from_state({**manifest, "format_version": 2}, states,
                             device="cpu")
    import json

    with open(os.path.join(d, "manifest.json")) as f:
        bad = {**json.load(f), "format_version": 3}
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump(bad, f)
    with pytest.raises(T.HNSWError, match="format version 3"):
        ShardedHNSW.restore(d, device="cpu")


def test_autosave(tmp_path):
    """Per-shard autosave: every shard's file lands within every_ops of
    its final size and loads in either package."""
    from redis_hnsw_tpu.utils.checkpoint import load_index as jax_load
    from redis_hnsw_tpu_torch.utils.checkpoint import load_index

    data = lattice(300, seed=9)
    names = [f"a{i}" for i in range(300)]
    idx = ShardedHNSW("sa", cfg(T, seed=4), mesh=make_mesh(8, device="cpu"))
    d = str(tmp_path / "auto")
    idx.enable_autosave(d, every_ops=8)
    idx.add_batch(names, data, batch_size=64)
    total = 0
    for s in range(idx.n_shards):
        p = os.path.join(d, f"shard{s}.npz")
        n_port = load_index(p, device="cpu").node_count
        assert jax_load(p).node_count == n_port
        total += n_port
    assert total >= 300 - 8 * idx.n_shards
    idx.disable_autosave()
    idx.add_node("late", data[0])
    idx.save(d)  # a manifest makes the directory restorable
    assert ShardedHNSW.restore(d, device="cpu").node_count == 301


# -- the client and the server --------------------------------------------------------


def test_sharded_index_kind(tmp_path):
    """tests/test_api.py::test_sharded_index_kind on the port's client."""
    rng = np.random.default_rng(0)
    client = T.HNSW(device="cpu")
    idx = client.create_index(
        "s", dim=16, m=8, ef_construction=48, seed=3,
        kind="sharded", n_shards=4,
    )
    assert idx.n_shards == 4
    assert client.create_index("one", dim=4, kind="sharded").n_shards == 1
    n = 300
    data = rng.standard_normal((n, 16)).astype(np.float32)
    names = [f"n{i}" for i in range(n)]
    client.add_batch("s", names, data)
    info = client.get_index("s")
    assert info["node_count"] == n and info["n_shards"] == 4
    res = client.search("s", data[7], k=3)
    assert res[0].name == "n7" and abs(res[0].sim) < 1e-5
    sims = [r.sim for r in res]
    assert sims == sorted(sims, reverse=True)
    bres = client.search_batch("s", data[:4], k=1)
    assert [r[0].name for r in bres] == names[:4]
    node = client.get_node("s", "n5")
    np.testing.assert_array_equal(node["data"], data[5])
    client.delete_node("s", "n5")
    assert client.get_index("s")["node_count"] == n - 1
    client.add_node("s", "n5", data[5])
    assert client.delete_batch("s", ["n9", "n10"]) == 2
    d = str(tmp_path / "shck")
    client.save_index("s", d)
    other = T.HNSW(device="cpu")
    back = other.restore_index(d, name="s2")
    assert back.node_count == n - 2 and back.n_shards == 4
    res2 = other.search("s2", data[7], k=3)
    assert [r.name for r in res2] == [r.name for r in res]


def test_sharded_kind_over_the_wire(tmp_path):
    """``KIND sharded`` over RESP: with 8 shards on each side (the JAX
    server's default mesh), every reply is the JAX server's, byte for
    byte -- node ops, HNSW.GET, the parity search, every ENGINE, SEEDS,
    a delete, SAVE + RESTORE of the directory. The port's server sizes
    a sharded index like its client: on the CPU, one shard."""
    class Sharded8(seeded(T.HNSW)):
        def create_index(self, *args, **kw):
            if kw.get("kind") == "sharded":
                kw["n_shards"] = 8
            return super().create_index(*args, **kw)

    pair = (serve(lambda: JSV.HNSWServer(port=0, client=seeded(J.HNSW)())),
            serve(lambda: TSV.HNSWServer(port=0,
                                         client=Sharded8(device="cpu"))))
    clients = [RawClient(s.server_address[1]) for s in pair]
    dim = 8
    q = [str(float(v)) for v in (2, 1, 0, 3, 2, 1, 0, 3)]
    script = [("HNSW.NEW", "sw", "DIM", dim, "M", 4, "KIND", "sharded")]
    script += [("HNSW.NODE.ADD", "sw", f"n{i}", "DATA", dim,
                *[str(float(v)) for v in row])
               for i, row in enumerate(lattice(40, seed=10))]
    script += [("HNSW.GET", "sw"), ("HNSW.NODE.GET", "sw", "n3"),
               ("HNSW.SEARCH", "sw", "K", 4, "QUERY", dim, *q)]
    script += [("HNSW.SEARCH", "sw", "K", 4, "QUERY", dim, *q, "ENGINE", e)
               for e in ("auto", "scan", "scan-approx", "graph")]
    script += [("HNSW.SEARCH", "sw", "K", 4, "QUERY", dim, *q, "ENGINE",
                "graph", "SEEDS", 2),
               ("HNSW.NODE.DEL", "sw", "n3"), ("HNSW.NODE.DEL", "sw", "n3"),
               ("HNSW.SEARCH", "sw", "K", 4, "QUERY", dim, *q, "ENGINE",
                "scan"),
               ("HNSW.SAVE", "sw", "PATH", "{dir}"),
               ("HNSW.DEL", "sw"), ("HNSW.GET", "sw"),
               ("HNSW.RESTORE", "sw", "PATH", "{dir}"), ("HNSW.GET", "sw"),
               ("HNSW.SEARCH", "sw", "K", 4, "QUERY", dim, *q, "ENGINE",
                "graph"),
               ("HNSW.DEL", "sw")]
    dirs = [str(tmp_path / "jax"), str(tmp_path / "port")]
    replies = []
    try:
        for parts in script:
            got = [c.cmd(*[str(p).replace("{dir}", d) for p in parts])
                   for c, d in zip(clients, dirs)]
            assert got[0] == got[1], (parts, got)
            replies.append(got[1])
    finally:
        for c in clients:
            c.close()
        stop(*pair)
    assert replies[0] == b"+OK\r\n"
    errors = [p[0] for p, r in zip(script, replies) if r.startswith(b"-")]
    assert errors == ["HNSW.NODE.DEL", "HNSW.GET"]  # the repeat, the gap
    assert os.path.exists(os.path.join(dirs[1], "manifest.json"))
