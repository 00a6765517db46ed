"""The torch port stands alone: it imports neither jax nor the JAX
package (its ``parallel/`` subpackage included), serves from the card
unless asked for the CPU (its default client too), and serves every
branch of the JAX package's client, at every k the JAX package serves."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import redis_hnsw_tpu_torch as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "redis_hnsw_tpu")


def test_import_leaves_jax_out():
    code = (
        "import sys; import redis_hnsw_tpu_torch; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr


def _port_sources():
    root = os.path.join(REPO, "redis_hnsw_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "profile_graph.py")


def test_no_jax_imports_in_port_sources():
    found = []
    sources = list(_port_sources())
    for sub in ("mesh.py", "sharded.py", "__init__.py"):
        assert os.path.join(REPO, "redis_hnsw_tpu_torch", "parallel",
                            sub) in sources
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            found += [
                (path, m) for m in mods if m.split(".")[0] in FORBIDDEN
            ]
    assert not found


def _outside_port(path: str) -> bool:
    port = os.path.join(REPO, "redis_hnsw_tpu_torch") + os.sep
    return not os.path.abspath(path).startswith(port)


def test_builds_compile_only_the_ports_sources(monkeypatch, tmp_path):
    """Every source the port's builds compile -- the host core and every
    CUDA kernel, with their headers -- lies under redis_hnsw_tpu_torch/,
    and so does every path a compiler command names: the port keeps its
    own copy of the host core (csrc/hnsw_core.cpp) and reads nothing of
    native/ or the JAX package."""
    from redis_hnsw_tpu_torch import native_core
    from redis_hnsw_tpu_torch.utils import build

    started = []

    def record(subdir, stem, sources, headers, cmd):
        started.append((stem, list(sources) + list(headers), cmd("OUT")))
        return "OUT", lambda: str(tmp_path / "none.so")

    monkeypatch.setattr(build, "start_build", record)
    monkeypatch.setattr(native_core, "start_build", record)
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(native_core, "_lib", None)
    monkeypatch.setattr(native_core, "_tried", False)
    assert native_core.load() is None  # the stub library does not load
    for name in build.KERNELS:
        build.start_kernel_build(name)
    stems = {stem for stem, _, _ in started}
    assert stems == {"libhnswcore"} | {f"lib{k}" for k in build.KERNELS}
    for stem, inputs, cmd in started:
        assert inputs and not [p for p in inputs if _outside_port(p)], stem
        named = [a for a in cmd if a.endswith((".cpp", ".cu", ".cuh"))]
        assert named and not [a for a in named if _outside_port(a)], stem
    assert native_core._SRC == os.path.join(
        REPO, "redis_hnsw_tpu_torch", "csrc", "hnsw_core.cpp")


def test_port_sources_name_no_outside_path():
    """No path the port's code builds -- a string with a slash, or a
    component of an ``os.path.join`` -- starts under native/ or the JAX
    package: nothing outside redis_hnsw_tpu_torch/ is opened or
    compiled (docstrings and comments may name them)."""
    outside = ("native", "redis_hnsw_tpu")
    found = []
    root = os.path.join(REPO, "redis_hnsw_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            for node in ast.walk(tree):
                if (isinstance(node, ast.Constant)
                        and isinstance(node.value, str)
                        and "/" in node.value and "\n" not in node.value
                        and node.value.split("/")[0] in outside):
                    found.append((path, node.value))
                if (isinstance(node, ast.Call)
                        and ast.unparse(node.func) == "os.path.join"):
                    found += [
                        (path, a.value) for a in node.args
                        if isinstance(a, ast.Constant) and a.value in outside
                    ]
    assert not found


def test_host_core_copy_builds_the_jax_packages_graph():
    """The port's host core is a copy of the JAX package's, the same code:
    its C entry points are the same, and the port's native and py
    backends build the same graph on lattice rows."""
    import re

    def entry_points(path):
        with open(path) as f:
            return sorted(set(re.findall(r"\b(hnsw_[a-z_0-9]+)\s*\(",
                                         f.read())))

    mine = os.path.join(REPO, "redis_hnsw_tpu_torch", "csrc",
                        "hnsw_core.cpp")
    theirs = os.path.join(REPO, "native", "hnsw_core.cpp")
    assert entry_points(mine) == entry_points(theirs)
    with open(mine) as a, open(theirs) as b:
        code = [[ln for ln in f.read().splitlines()
                 if not ln.lstrip().startswith("//")] for f in (a, b)]
    assert code[0] == code[1]  # only the header comment differs
    from redis_hnsw_tpu_torch import native_core

    if native_core.load() is None:
        pytest.skip("no g++ to build the host core")
    rng = np.random.default_rng(4)
    data = rng.integers(-3, 4, (300, 8)).astype(np.float32)
    graphs = []
    for backend in ("native", "py"):
        idx = T.HNSWIndex("c", T.IndexConfig(dim=8, m=5, seed=3,
                                             backend=backend), device="cpu")
        for i, row in enumerate(data):
            idx.add_node(f"n{i}", row)
        graphs.append([idx.get_node(f"n{i}")["neighbors"]
                       for i in range(300)])
    assert graphs[0] == graphs[1]


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = T.IndexConfig(dim=4)
    for make in (
        lambda: T.HNSW(),
        lambda: T.HNSW(device="cuda"),
        lambda: T.HNSWIndex("x", cfg),
        lambda: T.FlatIndex("x", cfg),
    ):
        with pytest.raises(T.HNSWError, match="no CUDA device"):
            make()
    assert T.HNSW(device="cpu").device.type == "cpu"
    # the module-level default client is made on the card, lazily
    import redis_hnsw_tpu_torch.api as A

    monkeypatch.setattr(A, "_DEFAULT", [])
    with pytest.raises(T.HNSWError, match="no CUDA device"):
        T.default_client
    with pytest.raises(T.HNSWError, match="no CUDA device"):
        A.default_client
    assert A._DEFAULT == []
    assert "default_client" not in T.__all__  # a star import stays off it
    with pytest.raises(AttributeError):
        T.no_such_name


def test_every_branch_is_served(monkeypatch, tmp_path):
    import redis_hnsw_tpu_torch.ops.search as S

    c = T.HNSW(device="cpu")
    c.create_index("g", dim=8, seed=1)
    c.create_index("f", dim=8, kind="flat")
    c.create_index("h", dim=64, metric="hamming")
    q = np.zeros((2, 8), np.float32)
    for i in range(20):
        c.add_node("g", f"n{i}", np.full(8, i, np.float32))
        c.add_node("f", f"n{i}", np.full(8, i, np.float32))
    c.add_node("h", "b0", np.zeros(2, np.uint32))

    # checkpoints (item 8) are served: save, autosave, restore
    ckpt = str(tmp_path / "g.npz")
    c.save_index("g", ckpt)
    c.index("g").enable_autosave(str(tmp_path / "auto.npz"), every_ops=1)
    c.add_node("g", "extra", np.full(8, 0.5, np.float32))
    assert os.path.exists(str(tmp_path / "auto.npz"))
    c.delete_node("g", "extra")
    c.index("g").disable_autosave()
    assert c.restore_index(ckpt, name="g2").node_count == 20
    # hamming is served: the scan, the graph engine and the flat kind
    hq = np.zeros((1, 2), np.uint32)
    for engine in ("auto", "scan", "graph"):
        assert [r.name for r in c.search_batch("h", hq, engine=engine)[0]
                ] == ["b0"]
    c.create_index("hf", dim=64, kind="flat", metric="hamming")
    c.add_batch("hf", ["x", "y"], np.array([[0, 1], [0, 0]], np.uint32))
    for pallas in (False, True):
        got = c.index("hf").search_batch(hq, 2, use_pallas=pallas)[0]
        assert [(r.name, r.sim) for r in got] == [("y", 0.0), ("x", -1.0)]
    # the scan-approx tier (item 10) is served, and equals the exact tier
    exact = {i: c.search_batch(i, q, k=3, engine="scan") for i in "gf"}
    for idx in "gf":
        assert c.search_batch(idx, q, k=3, engine="scan-approx") == exact[idx]
        assert c.search_batch(idx, q, k=3, recall_target=0.9) == exact[idx]
    # sharding (item 12) is served: create, fill, search, a directory
    # checkpoint restored
    sh = c.create_index("s", dim=8, seed=1, kind="sharded", n_shards=3)
    assert sh.n_shards == 3 and {d.type for d in sh.devices} == {"cpu"}
    c.add_batch("s", [f"n{i}" for i in range(20)],
                np.arange(20, dtype=np.float32)[:, None].repeat(8, 1))
    for engine in ("auto", "scan", "graph"):
        assert c.search_batch("s", q, k=3, engine=engine) == exact["g"]
    c.save_index("s", str(tmp_path / "sharded"))
    back = c.restore_index(str(tmp_path / "sharded"), name="s2")
    assert back.n_shards == 3
    assert c.search_batch("s2", q, k=3) == exact["g"]
    # the bf16 and int8 scan tiers (item 9) are served on both kinds
    for value in ("bf16", "int8"):
        monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_DTYPE", value)
        for idx in "gf":
            assert c.search_batch(idx, q, k=3, engine="scan") == exact[idx]
            assert c.search_batch(idx, q, k=3) == exact[idx]
        assert c.index("f").search_batch(q, 3, use_pallas=True) == exact["f"]
    monkeypatch.delenv("REDIS_HNSW_TPU_SCAN_DTYPE")
    # ids-only replies (item 11) are served on both engines and kinds
    for value in ("ids", "ids-force"):
        monkeypatch.setenv("REDIS_HNSW_TPU_REPLY", value)
        for idx in "gf":
            assert c.search_batch(idx, q, k=3) == exact[idx]
        assert len(c.search_batch("g", q, k=3, engine="graph")[0]) == 3
    monkeypatch.delenv("REDIS_HNSW_TPU_REPLY")
    # the serving extras (item 11) are exported
    assert callable(T.tune) and callable(T.run_mixed)
    # the graph engine is served: engine="graph", and "auto" above the
    # scan cap
    assert len(c.search_batch("g", q, k=3, engine="graph")[0]) == 3
    with monkeypatch.context() as mp:
        mp.setitem(S.SCAN_MAX_ROWS, "euclidean", 64)
        assert c.search_batch("g", q, k=3) == c.search_batch(
            "g", q, k=3, engine="graph")
    monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", "1")
    monkeypatch.setenv("REDIS_HNSW_TPU_CERT_ONEPASS", "1")
    # the one-pass certified select is served (k <= N/128 here)
    assert len(c.search_batch("f", q, k=1)[0]) == 1
    assert len(c.search_batch("f", q, k=3)[0]) == 3  # the two-pass gate
    monkeypatch.setenv("REDIS_HNSW_TPU_CERT_ONEPASS", "0")
    assert len(c.search_batch("f", q, k=3)[0]) == 3
    monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_DTYPE", "f64")
    with pytest.raises(ValueError, match="SCAN_DTYPE"):
        c.search_batch("g", q)
    monkeypatch.delenv("REDIS_HNSW_TPU_SCAN_DTYPE")


@pytest.mark.parametrize(
    "metric,k,cert",
    [("euclidean", 65, "1"),    # the two-pass tier selects k_sel = 260
     ("euclidean", 257, "0"),   # the exact tier above 256
     ("euclidean", 300, "0"),
     ("hamming", 300, "0")],    # kernel A′'s plain route past k = 256
)
def test_wide_k_matches_jax(monkeypatch, metric, k, cert):
    """Every k the JAX package serves is served, on a 400-row flat index:
    replies equal the JAX package's byte for byte on lattice data."""
    import jax  # noqa: F401  (the JAX package, CPU-pinned by conftest)

    import redis_hnsw_tpu as J

    monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", cert)
    monkeypatch.setenv("REDIS_HNSW_TPU_CERT_ONEPASS", "0")
    rng = np.random.default_rng(k)
    if metric == "hamming":
        data = rng.integers(0, 2**32, (400, 3), dtype=np.uint32)
        data[300:310] = data[7]  # a tie class
        qs = rng.integers(0, 2**32, (5, 3), dtype=np.uint32)
        qs[0] = data[7]
        dim = 96
    else:
        data = rng.integers(-3, 4, (400, 8)).astype(np.float32)
        data[200:220] = data[0:20]  # ties at every score
        qs = rng.integers(-3, 4, (5, 8)).astype(np.float32)
        dim = 8
    names = [f"b{i}" for i in range(400)]
    got, want = (
        pkg.FlatIndex("big", pkg.IndexConfig(dim=dim, metric=metric), **kw)
        for pkg, kw in ((T, dict(device="cpu")), (J, {}))
    )
    for idx in (got, want):
        idx.add_batch(names, data)
        idx.delete_batch(names[::9])
    g = got.search_batch(qs, k, reply="columnar")
    w = want.search_batch(qs, k, reply="columnar")
    assert g[0].shape == (5, k)
    assert np.array_equal(g[0], w[0])
    if metric == "hamming":
        # by value: the port replies a zero distance as -0.0 where the
        # JAX package's flat exact path gives +0.0 (ROADMAP queue 3)
        assert np.array_equal(g[1], w[1])
        assert np.signbit(g[1][0, :10]).all()
    else:
        assert np.array_equal(g[1].view(np.int32), w[1].view(np.int32))
