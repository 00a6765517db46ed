"""RESP (Redis protocol) server: the reference's wire surface.

Port of ``redis_hnsw_tpu/server.py``; every reply is the same bytes as
the JAX server's. The reference is consumed through redis-cli or any
Redis client (Readme.md:33, cmd.sh). This module serves the same seven
``HNSW.*`` commands over RESP2 on a TCP socket, backed by an in-process
client (api.HNSW) on the card, so the reference's clients and scripts
work unchanged:

    python -m redis_hnsw_tpu_torch.server --port 6399
    redis-cli -p 6399 HNSW.NEW test1 DIM 128 M 5
    redis-cli -p 6399 HNSW.NODE.ADD test1 node1 DATA 128 1 1 ... 1
    redis-cli -p 6399 HNSW.SEARCH test1 K 5 QUERY 128 2 2 ... 2

Command grammar matches the reference's declarative schemas
(src/lib.rs:37-129): positional args then kwargs; DATA/QUERY are a
dimensionality followed by that many values. Reply shapes mirror the
reference's encoders:
  HNSW.NEW / HNSW.NODE.ADD -> +OK          (lib.rs:170, :367)
  HNSW.DEL / HNSW.NODE.DEL -> :1           (lib.rs:226, :406)
  HNSW.GET      -> flat [field, value, ...] (types.rs:122-155)
  HNSW.NODE.GET -> [data, [...], neighbors, [[...], ...]] (types.rs:322-352)
  HNSW.SEARCH   -> [count, [similarity, s, name, n], ...] (lib.rs:484-495)

Commands execute serially (one lock), like Redis's event loop -- the
reference's concurrency model.

Extensions beyond the reference's seven commands, as in the JAX server:
HNSW.SAVE / HNSW.RESTORE give wire-level durability (checkpoint files
either package reads), and HNSW.SEARCH accepts ENGINE
auto|graph|scan|scan-approx to route through the batched device engines
(ops/search.py) instead of the host parity path, SEEDS n (with ENGINE
graph) to seed the beam with per-lane pivot entrypoints, and
RECALL_TARGET f to make the route a guarantee. ``KIND sharded`` is not
ported yet and replies with its error (ROADMAP queue 1 item 12).
"""

from __future__ import annotations

import socket
import socketserver
import threading

import numpy as np

from .api import HNSW
from .errors import HNSWError

CRLF = b"\r\n"


# -- RESP encoding -----------------------------------------------------------

def _enc(obj) -> bytes:
    """Encode a python object as RESP2 (module-reply conventions)."""
    if isinstance(obj, SimpleString):
        return b"+" + str(obj).encode() + CRLF
    if isinstance(obj, Error):
        return b"-" + str(obj).encode() + CRLF
    if isinstance(obj, bool):
        return b":" + (b"1" if obj else b"0") + CRLF
    if isinstance(obj, (int, np.integer)):
        return b":" + str(int(obj)).encode() + CRLF
    if isinstance(obj, (float, np.floating)):
        # RedisModule_ReplyWithDouble -> bulk string
        s = repr(float(obj)).encode()
        return b"$" + str(len(s)).encode() + CRLF + s + CRLF
    if obj is None:
        return b"$-1" + CRLF
    if isinstance(obj, (bytes, str)):
        b = obj if isinstance(obj, bytes) else obj.encode()
        return b"$" + str(len(b)).encode() + CRLF + b + CRLF
    if isinstance(obj, (list, tuple)):
        out = b"*" + str(len(obj)).encode() + CRLF
        return out + b"".join(_enc(x) for x in obj)
    raise TypeError(f"cannot encode {type(obj)!r}")


class SimpleString(str):
    pass


class Error(str):
    pass


OK = SimpleString("OK")


# -- RESP decoding -----------------------------------------------------------

class _Reader:
    def __init__(self, sock: socket.socket) -> None:
        self._f = sock.makefile("rb")

    def _line(self) -> bytes | None:
        line = self._f.readline()
        if not line:
            return None
        return line.rstrip(b"\r\n")

    def read_command(self) -> list[str] | None:
        """One client command: a RESP array of bulk strings, or an
        inline command line (redis also accepts those)."""
        line = self._line()
        if line is None:
            return None
        if not line:
            return []
        if line[:1] == b"*":
            n = int(line[1:])
            parts = []
            for _ in range(n):
                hdr = self._line()
                if hdr is None or hdr[:1] != b"$":
                    return None
                ln = int(hdr[1:])
                data = self._f.read(ln + 2)[:ln]
                parts.append(data.decode())
            return parts
        return line.decode().split()


# -- command layer ------------------------------------------------------------

def _kwargs(args: list[str], vec_keys: tuple[str, ...] = ()) -> dict:
    """Parse the reference's kwarg grammar: KEY value, or KEY count
    v1..vcount for vector-valued keys (src/lib.rs command! schemas).
    Vector values stay raw strings -- conversion is metric-dependent
    (f32 for euclidean, packed uint32 words for hamming), see _vec."""
    out: dict = {}
    i = 0
    while i < len(args):
        key = args[i].lower()
        if key in vec_keys:
            try:
                count = int(args[i + 1])
            except (IndexError, ValueError):
                raise HNSWError(
                    f"missing or invalid count for argument {key}"
                ) from None
            vals = args[i + 2 : i + 2 + count]
            if len(vals) != count:
                raise HNSWError("data dimensionality mismatch")
            out[key] = vals
            i += 2 + count
        else:
            if i + 1 >= len(args):
                raise HNSWError(f"missing value for argument {key}")
            out[key] = args[i + 1]
            i += 2
    return out


def _vec(vals: list[str], metric: str) -> np.ndarray:
    """Convert raw wire values per the index's metric. Euclidean: f32
    (reference grammar, f64 cast to f32 at src/lib.rs:345-346).
    Hamming: uint32-packed words, so a 256-bit index takes
    ``DATA 8 w1..w8`` (decimal or 0x-prefixed)."""
    try:
        if metric == "hamming":
            return np.asarray(
                [int(v, 0) & 0xFFFFFFFF for v in vals], dtype=np.uint32
            )
        return np.asarray([float(v) for v in vals], dtype=np.float32)
    except ValueError as e:
        raise HNSWError(f"invalid vector value: {e}") from None


class Dispatcher:
    def __init__(self, client: HNSW) -> None:
        self.client = client
        self.lock = threading.Lock()  # serialize like Redis's event loop

    def __call__(self, parts: list[str]):
        if not parts:
            return Error("ERR empty command")
        cmd = parts[0].lower()
        args = parts[1:]
        with self.lock:
            try:
                return self._dispatch(cmd, args)
            except HNSWError as e:
                return Error(str(e))
            except Exception as e:  # malformed args etc.
                return Error(f"ERR {e}")

    def _dispatch(self, cmd: str, args: list[str]):
        c = self.client
        if cmd == "ping":
            return SimpleString(args[0]) if args else SimpleString("PONG")
        if cmd in ("command", "hello", "info", "client"):
            return []  # enough for client handshakes
        if cmd == "hnsw.new":
            if not args:
                raise HNSWError("missing index name")
            kw = _kwargs(args[1:])
            if "dim" not in kw:
                raise HNSWError("missing required argument data_dim")
            # METRIC/CAPACITY/KIND extend the reference's grammar
            # (src/lib.rs:37-56: only DIM/M/EFCON exist upstream; hamming
            # is declared-but-missing there, Readme.md:8). KIND sharded
            # replies with its NotImplementedError (item 12).
            c.create_index(
                args[0],
                dim=int(kw["dim"]),
                m=int(kw.get("m", 5)),
                ef_construction=int(kw.get("efcon", 200)),
                metric=kw.get("metric", "euclidean").lower(),
                capacity=int(kw.get("capacity", 1024)),
                kind=kw.get("kind", "hnsw").lower(),
            )
            return OK
        if cmd == "hnsw.get":
            info = c.get_index(args[0])
            # Full 9-field reply for every kind (types.rs:122-155).
            # kind=flat has no graph: its graph-only fields come back
            # None from info() and encode as RESP nulls ($-1); the
            # graph kinds keep their established shapes (enterpoint ""
            # when unset, matching the reference's empty enterpoint).
            def fld(key, cast):
                v = info[key]
                return None if v is None else cast(v)
            return [
                "name", info["name"],
                "metric", info["metric"],
                "data_dim", int(info["data_dim"]),
                "m", fld("m", int),
                "ef_construction", fld("ef_construction", int),
                "level_mult", fld("level_mult", float),
                "node_count", int(info["node_count"]),
                "max_layer", fld("max_layer", int),
                "enterpoint", (info["enterpoint"] or ""
                               if info.get("m") is not None else None),
            ]
        if cmd == "hnsw.del":
            return c.delete_index(args[0])
        if cmd == "hnsw.node.add":
            if len(args) < 2:
                raise HNSWError("missing index or node name")
            kw = _kwargs(args[2:], vec_keys=("data",))
            if "data" not in kw:
                raise HNSWError("missing required argument data")
            metric = c.index(args[0]).config.metric
            c.add_node(args[0], args[1], _vec(kw["data"], metric))
            return OK
        if cmd == "hnsw.node.get":
            if len(args) < 2:
                raise HNSWError("missing index or node name")
            node = c.get_node(args[0], args[1])
            data = node["data"]
            if np.issubdtype(np.asarray(data).dtype, np.integer):
                vals = [int(x) for x in data]  # hamming packed words
            else:
                vals = [float(x) for x in data]
            return [
                "data", vals,
                "neighbors",
                [list(layer) for layer in node["neighbors"]],
            ]
        if cmd == "hnsw.node.del":
            return c.delete_node(args[0], args[1])
        if cmd == "hnsw.save":
            # Wire-level durability: the reference gets persistence for
            # free from Redis RDB snapshots of its keyspace
            # (src/types.rs:157-284); standalone serving needs an explicit
            # command pair. HNSW.SAVE <index> PATH <path> -> +OK
            kw = _kwargs(args[1:])
            c.save_index(args[0], kw["path"])
            return OK
        if cmd == "hnsw.restore":
            # HNSW.RESTORE <index> PATH <path> -> +OK; registers the
            # checkpoint under <index> (restart story for RESP clients).
            kw = _kwargs(args[1:])
            c.restore_index(kw["path"], name=args[0])
            return OK
        if cmd == "hnsw.search":
            if not args:
                raise HNSWError("missing index name")
            kw = _kwargs(args[1:], vec_keys=("query",))
            if "query" not in kw:
                raise HNSWError("missing required argument query")
            k = int(kw.get("k", 5))
            metric = c.index(args[0]).config.metric
            q = _vec(kw["query"], metric)
            if "engine" in kw or "recall_target" in kw:
                # ENGINE auto|graph|scan|scan-approx extends the
                # reference grammar: route through the batched device
                # engines (B=1) instead of the host parity path.
                # SEEDS n adds pivot entrypoints to the graph beam.
                # RECALL_TARGET f makes the route a guarantee
                # (ops/search.py resolve_engine).
                rt = kw.get("recall_target")
                res = c.search_batch(
                    args[0], q[None], k=k,
                    engine=kw.get("engine", "auto").lower(),
                    seeds=int(kw.get("seeds", 0)),
                    recall_target=None if rt is None else float(rt),
                )[0]
            else:
                res = c.search(args[0], q, k=k)
            reply: list = [len(res)]
            for r in res:
                reply.append(
                    ["similarity", float(r.sim), "name", r.name]
                )
            return reply
        return Error(f"ERR unknown command '{cmd}'")


class _Handler(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        reader = _Reader(self.request)
        dispatch = self.server.dispatch  # type: ignore[attr-defined]
        while True:
            try:
                parts = reader.read_command()
            except (ValueError, ConnectionError):
                break
            if parts is None:
                break
            if parts and parts[0].lower() == "quit":
                self.request.sendall(_enc(OK))
                break
            try:
                self.request.sendall(_enc(dispatch(parts)))
            except (BrokenPipeError, ConnectionError):
                break


class HNSWServer(socketserver.ThreadingTCPServer):
    """Serve a (possibly shared) HNSW client registry over RESP. With no
    ``client``, a new HNSW() on ``device`` (None = the card)."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, host: str = "127.0.0.1", port: int = 6399,
                 client: HNSW | None = None, device=None) -> None:
        self.dispatch = Dispatcher(
            client if client is not None else HNSW(device)
        )
        super().__init__((host, port), _Handler)

    def serve_background(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t


def main() -> None:  # pragma: no cover - manual entry
    import argparse

    ap = argparse.ArgumentParser(
        description="RESP server for redis_hnsw_tpu_torch"
    )
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=6399)
    ap.add_argument(
        "--device", default="cuda",
        help="device the indexes live on (default cuda; cpu to run "
        "without a card)",
    )
    ap.add_argument(
        "--restore", nargs="*", default=(), metavar="PATH",
        help="checkpoints (npz, of either package) to register at startup",
    )
    args = ap.parse_args()
    srv = HNSWServer(args.host, args.port, device=args.device)
    for path in args.restore:
        idx = srv.dispatch.client.restore_index(path)
        print(f"restored index {idx.name!r} from {path}")
    print(f"serving HNSW.* on {args.host}:{args.port}")
    srv.serve_forever()


if __name__ == "__main__":
    main()
