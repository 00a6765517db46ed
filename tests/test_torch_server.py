"""The port's RESP server against the JAX package's, byte for byte.

Both servers run on ephemeral ports, the port's over
``HNSW(device="cpu")``; one command script (the reference's cmd.sh flow
and every case of ``tests/test_server.py``) goes to each, and the raw
RESP bytes of every reply must be equal. Both clients seed their indexes
alike, so the graphs (and HNSW.GET / HNSW.NODE.GET) agree; the vectors
and queries are lattice points, so every similarity is exact in f32 and
prints the same. One reply differs by design: the graph engine's
recall_target error names each package's own ``tune()``.
"""

import socket

import numpy as np
import pytest

import redis_hnsw_tpu as J
import redis_hnsw_tpu_torch as T
from redis_hnsw_tpu import server as JS
from redis_hnsw_tpu_torch import server as TS


def seeded(cls):
    class Seeded(cls):
        def create_index(self, *args, seed=7, **kw):
            return super().create_index(*args, seed=seed, **kw)

    return Seeded


class RawClient:
    """Sends RESP commands and reads each reply's raw bytes."""

    def __init__(self, port: int) -> None:
        self.sock = socket.create_connection(("127.0.0.1", port))
        self.f = self.sock.makefile("rb")

    def cmd(self, *parts) -> bytes:
        out = [f"*{len(parts)}\r\n".encode()]
        for p in parts:
            b = str(p).encode()
            out.append(b"$%d\r\n%s\r\n" % (len(b), b))
        self.sock.sendall(b"".join(out))
        return self._raw()

    def _raw(self) -> bytes:
        line = self.f.readline()
        t, n = line[:1], line[1:-2]
        if t == b"$" and int(n) >= 0:
            line += self.f.read(int(n) + 2)
        elif t == b"*":
            for _ in range(int(n)):
                line += self._raw()
        return line

    def close(self):
        self.sock.close()


def serve(make):
    srv = make()
    srv.serve_background()
    return srv


def stop(*servers):
    for srv in servers:
        srv.shutdown()
        srv.server_close()


@pytest.fixture
def pair():
    """(jax server, port server), each on a fresh registry."""
    a = serve(lambda: JS.HNSWServer(port=0, client=seeded(J.HNSW)()))
    b = serve(lambda: TS.HNSWServer(
        port=0, client=seeded(T.HNSW)(device="cpu")))
    yield a, b
    stop(a, b)


def run_script(pair, script, dirs=None):
    """Send ``script`` to both servers; every reply's bytes must match.
    ``{dir}`` in an argument is each server's own directory. Returns the
    port server's replies."""
    clients = [RawClient(s.server_address[1]) for s in pair]
    got = []
    try:
        for parts in script:
            replies = []
            for i, c in enumerate(clients):
                args = [str(p).replace("{dir}", dirs[i]) if dirs else p
                        for p in parts]
                replies.append(c.cmd(*args))
            assert replies[0] == replies[1], (parts, replies)
            got.append(replies[1])
    finally:
        for c in clients:
            c.close()
    return got


OK = b"+OK\r\n"


def vec(v, dim):
    return [str(float(v))] * dim


def cmd_sh_flow(dim=16, n=30):
    script = [("PING",), ("PING", "hello"), ("COMMAND",),
              ("HNSW.NEW", "test1", "DIM", dim, "M", 5),
              ("HNSW.GET", "test1")]
    script += [("HNSW.NODE.ADD", "test1", f"node{i}", "DATA", dim,
                *vec(i, dim)) for i in range(1, n + 1)]
    script += [("HNSW.GET", "test1"),
               ("HNSW.NODE.GET", "test1", "node1"),
               ("HNSW.NODE.GET", "test1", "node17"),
               ("HNSW.SEARCH", "test1", "K", 3, "QUERY", dim, *vec(2, dim)),
               ("HNSW.SEARCH", "test1", "QUERY", dim, *vec(11.25, dim)),
               ("HNSW.SEARCH", "test1", "K", 40, "QUERY", dim,
                *vec(0, dim)),
               ("HNSW.NEW", "test1", "DIM", dim),
               ("HNSW.NODE.GET", "test1", "nope")]
    script += [("HNSW.NODE.DEL", "test1", f"node{i}")
               for i in range(1, n + 1, 2)]
    script += [("HNSW.GET", "test1"),
               ("HNSW.SEARCH", "test1", "K", 3, "QUERY", dim, *vec(2, dim)),
               ("HNSW.NODE.GET", "test1", "node2")]
    script += [("HNSW.NODE.DEL", "test1", f"node{i}")
               for i in range(2, n + 1, 2)]
    script += [("HNSW.DEL", "test1"), ("HNSW.GET", "test1")]
    return script


def test_cmd_sh_flow_bytes(pair):
    got = run_script(pair, cmd_sh_flow())
    assert got[0] == b"+PONG\r\n"
    assert got[-1] == b"-Index: test1 does not exist\r\n"


def test_quit_bytes(pair):
    replies = []
    for srv in pair:
        c = RawClient(srv.server_address[1])
        replies.append(c.cmd("QUIT"))
        assert c.f.readline() == b""  # the server closed the connection
        c.close()
    assert replies == [b"+OK\r\n", b"+OK\r\n"]


def build_script(name, dim, n, extra=()):
    return [("HNSW.NEW", name, "DIM", dim, "M", 5, *extra)] + [
        ("HNSW.NODE.ADD", name, f"node{i}", "DATA", dim, *vec(i, dim))
        for i in range(1, n + 1)
    ]


def test_save_restore_bytes(pair, tmp_path):
    """HNSW.SAVE, a restart (fresh servers), HNSW.RESTORE: the same
    bytes, whichever package wrote the checkpoint the port restores."""
    dirs = []
    for d in ("jax", "port"):
        (tmp_path / d).mkdir()
        dirs.append(str(tmp_path / d))
    dim = 8
    query = ("HNSW.SEARCH", "dur", "K", 3, "QUERY", dim, *vec(2, dim))
    script = build_script("dur", dim, 20) + [
        ("HNSW.SAVE", "dur", "PATH", "{dir}/dur.npz"),
        ("HNSW.SAVE", "ghost", "PATH", "{dir}/ghost.npz"),
        ("HNSW.SAVE", "dur"),
        query,
    ]
    before = run_script(pair, script, dirs)
    assert before[-4] == b"+OK\r\n"
    swapped = list(reversed(dirs))  # each restores the other's file
    missing = str(tmp_path / "missing.npz")  # one path: the same error
    for restore_dirs in (dirs, swapped):
        a = serve(lambda: JS.HNSWServer(port=0, client=seeded(J.HNSW)()))
        b = serve(lambda: TS.HNSWServer(
            port=0, client=seeded(T.HNSW)(device="cpu")))
        try:
            after = run_script((a, b), [
                ("HNSW.GET", "dur"),
                ("HNSW.RESTORE", "dur", "PATH", "{dir}/dur.npz"),
                ("HNSW.RESTORE", "dur", "PATH", "{dir}/dur.npz"),
                ("HNSW.RESTORE", "copy", "PATH", "{dir}/dur.npz"),
                ("HNSW.GET", "dur"),
                ("HNSW.NODE.GET", "copy", "node5"),
                query,
                ("HNSW.SEARCH", "copy", "K", 3, "QUERY", dim,
                 *vec(2, dim), "ENGINE", "graph"),
                ("HNSW.RESTORE", "x", "PATH", missing),
            ], restore_dirs)
        finally:
            stop(a, b)
        assert after[1] == b"+OK\r\n"
        assert after[6] == before[-1]


def test_hamming_bytes(pair):
    script = [("HNSW.NEW", "ham", "DIM", 64, "M", 5, "METRIC", "hamming"),
              ("HNSW.GET", "ham")]
    words = {"a": (0, 0), "b": (0xFFFFFFFF, 0xFFFFFFFF), "c": (0xFF, 0),
             "d": (0, 1)}
    script += [("HNSW.NODE.ADD", "ham", nm, "DATA", 2, w0, w1)
               for nm, (w0, w1) in words.items()]
    script += [
        ("HNSW.NODE.ADD", "ham", "e", "DATA", 2, "0xF0", "0x0"),
        ("HNSW.SEARCH", "ham", "K", 3, "QUERY", 2, 0, 0),
        ("HNSW.SEARCH", "ham", "K", 5, "QUERY", 2, "0xFF", 1),
        ("HNSW.NODE.GET", "ham", "b"),
        ("HNSW.NODE.GET", "ham", "e"),
        ("HNSW.DEL", "ham"),
    ]
    got = run_script(pair, script)
    assert got[7].startswith(b"*4\r\n:3\r\n")


def test_error_reply_bytes(pair):
    dim = 8
    script = [
        ("HNSW.NEW", "err1", "DIM", dim),
        ("HNSW.NODE.ADD", "err1", "n1", "DATA", dim, *["1"] * dim),
        ("HNSW.NEW", "err1", "DIM", dim),
        ("HNSW.SEARCH", "ghost", "QUERY", dim, *["0"] * dim),
        ("HNSW.NODE.ADD", "ghost", "n", "DATA", dim, *["0"] * dim),
        ("HNSW.DEL", "ghost"),
        ("HNSW.NODE.ADD", "err1", "n1", "DATA", dim, *["2"] * dim),
        ("HNSW.NODE.DEL", "err1", "ghost"),
        ("HNSW.NODE.ADD", "err1", "n2", "DATA", 4, 1, 2, 3, 4),
        ("HNSW.SEARCH", "err1", "QUERY", 4, 1, 2, 3, 4),
        ("HNSW.NODE.ADD", "err1", "n2", "DATA", dim, 1, 2),
        ("HNSW.NEW", "err2", "DIM"),
        ("HNSW.NEW", "err2", "M", 5),
        ("HNSW.NODE.ADD", "err1", "n2"),
        ("HNSW.NODE.ADD", "err1"),
        ("HNSW.SEARCH", "err1", "K", 3),
        ("HNSW.SEARCH",),
        ("HNSW.NEW",),
        ("HNSW.NODE.ADD", "err1", "n2", "DATA", dim, *["x"] * dim),
        ("HNSW.NODE.ADD", "err1", "n2", "DATA", "many", 1),
        ("HNSW.NEW", "err3", "DIM", 8, "M", 1),
        ("HNSW.NEW", "err3", "DIM", 40, "METRIC", "hamming"),
        ("HNSW.NEW", "err3", "DIM", 8, "KIND", "tree"),
        ("HNSW.FROB", "err1"),
        ("PING",),
        ("HNSW.DEL", "err1"),
    ]
    got = run_script(pair, script)
    assert all(r.startswith(b"-") for r in got[2:24]), got
    assert got[-2:] == [b"+PONG\r\n", b":1\r\n"]


def test_flat_kind_bytes(pair):
    script = [("HNSW.NEW", "fw", "DIM", 4, "KIND", "flat")]
    script += [("HNSW.NODE.ADD", "fw", f"n{i}", "DATA", 4, *vec(i, 4))
               for i in range(3)]
    script += [
        ("HNSW.SEARCH", "fw", "K", 10, "QUERY", 4, *vec(0, 4)),
        ("HNSW.SEARCH", "fw", "K", 2, "QUERY", 4, *vec(1.25, 4),
         "ENGINE", "scan-approx"),
        ("HNSW.SEARCH", "fw", "K", 2, "QUERY", 4, *vec(1.25, 4),
         "RECALL_TARGET", "0.9"),
        ("HNSW.SEARCH", "fw", "K", 2, "QUERY", 4, *vec(1.25, 4),
         "ENGINE", "graph"),
        ("HNSW.GET", "fw"),
        ("HNSW.NODE.GET", "fw", "n1"),
        ("HNSW.NODE.DEL", "fw", "n1"),
        ("HNSW.SEARCH", "fw", "K", 10, "QUERY", 4, *vec(0, 4)),
        ("HNSW.DEL", "fw"),
    ]
    got = run_script(pair, script)
    assert got[4].startswith(b"*4\r\n:3\r\n")


@pytest.mark.parametrize("metric", ["euclidean", "hamming"])
def test_engine_seeds_recall_target_bytes(pair, metric):
    """ENGINE auto|scan|scan-approx|graph, SEEDS and RECALL_TARGET route
    through the batched engines the same way in both servers."""
    if metric == "hamming":
        dim, w = 64, 2
        rng = np.random.default_rng(3)
        data = rng.integers(0, 2**32, (30, w), dtype=np.uint32)
        rows = [[str(int(x)) for x in r] for r in data]
        q = [str(int(x)) for x in data[7] ^ np.uint32(5)]
        extra = ("METRIC", "hamming")
    else:
        dim, w = 8, 8
        rows = [vec(i, dim) for i in range(30)]
        q = vec(7.25, dim)
        extra = ()
    script = [("HNSW.NEW", "ew", "DIM", dim, "M", 5, *extra)]
    script += [("HNSW.NODE.ADD", "ew", f"n{i}", "DATA", w, *rows[i])
               for i in range(30)]
    search = ("HNSW.SEARCH", "ew", "K", 3, "QUERY", w, *q)
    script += [search]
    script += [(*search, "ENGINE", e)
               for e in ("auto", "scan", "scan-approx", "graph", "AUTO")]
    script += [
        (*search, "ENGINE", "graph", "SEEDS", 4),
        (*search, "ENGINE", "scan", "SEEDS", 4),
        (*search, "RECALL_TARGET", "1.0"),
        (*search, "RECALL_TARGET", "0.95"),
        (*search, "RECALL_TARGET", "0.999"),
        (*search, "ENGINE", "scan", "RECALL_TARGET", "0.5"),
        (*search, "RECALL_TARGET", "1.5"),
        (*search, "ENGINE", "warp"),
        ("HNSW.DEL", "ew"),
    ]
    got = run_script(pair, script)
    assert all(r == got[31] for r in got[32:36])  # scan engines == auto


def test_graph_recall_target_error(pair):
    """The one reply that differs: the error names each package's
    tune()."""
    script = build_script("rt", 8, 5)
    run_script(pair, script)
    replies = []
    for srv in pair:
        c = RawClient(srv.server_address[1])
        replies.append(c.cmd("HNSW.SEARCH", "rt", "K", 3, "QUERY", 8,
                             *vec(2, 8), "ENGINE", "graph",
                             "RECALL_TARGET", "0.9"))
        c.close()
    assert replies[1] == replies[0].replace(
        b"redis_hnsw_tpu.tune()", b"redis_hnsw_tpu_torch.tune()")
    assert b"redis_hnsw_tpu_torch.tune()" in replies[1]


def test_sharded_kind_replies_item_12(pair, tmp_path):
    """KIND sharded round trip on the port's server (one shard on the
    CPU; tests/test_torch_sharded.py holds 8 shards to the JAX server's
    bytes): create, add, search, save the directory, drop, restore."""
    c = RawClient(pair[1].server_address[1])
    d = str(tmp_path / "sw")
    assert c.cmd("HNSW.NEW", "sw", "DIM", 8, "KIND", "sharded") == OK
    for i in range(12):
        assert c.cmd("HNSW.NODE.ADD", "sw", f"n{i}", "DATA", 8,
                     *vec(i, 8)) == OK
    search = ("HNSW.SEARCH", "sw", "K", 2, "QUERY", 8, *vec(3, 8))
    first = c.cmd(*search)
    assert first.startswith(b"*3\r\n:2\r\n") and b"$2\r\nn3\r\n" in first
    assert c.cmd(*search, "ENGINE", "graph") == first
    assert b"node_count\r\n:12\r\n" in c.cmd("HNSW.GET", "sw")
    assert c.cmd("HNSW.SAVE", "sw", "PATH", d) == OK
    assert c.cmd("HNSW.DEL", "sw") == b":1\r\n"
    assert c.cmd("HNSW.GET", "sw") == b"-Index: sw does not exist\r\n"
    assert c.cmd("HNSW.RESTORE", "sw", "PATH", d) == OK
    assert c.cmd(*search) == first
    c.close()


def test_server_without_a_card_refuses(monkeypatch):
    """HNSWServer() builds its client on the card, never the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(T.HNSWError, match="no CUDA device"):
        TS.HNSWServer(port=0)
