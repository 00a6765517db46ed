"""The object reply made in one native call (redis_hnsw_tpu_torch/csrc/
reply.cpp, loaded by native_reply.py): ``SearchResult`` as a native type
with the dataclass's surface, tracked by the cycle collector only while
a field may hold a cycle, and ``build_reply`` against the reply's plain
rule. Each case runs in both forms where both apply: the native
extension (built with g++ at first use) and the pure-Python fallback
that serves where it cannot be built. Where it cannot be built here,
the native cases skip and the fallback's run."""

import copy
import gc
import os
import pickle
import re
import sys
import weakref

import numpy as np
import pytest

import redis_hnsw_tpu_torch as T
from redis_hnsw_tpu_torch import native_reply
from redis_hnsw_tpu_torch.models import hnsw as TH
from redis_hnsw_tpu_torch.ops import search as TSE
from redis_hnsw_tpu_torch.parallel import ShardedHNSW, make_mesh
from redis_hnsw_tpu_torch.utils import profiling as P

NEG_INF = float("-inf")


def prefetch_distances():
    """(kNameAhead, kSlotAhead) of csrc/reply.cpp: how many slots ahead
    ``build_reply`` fetches each answer's name object and names-array
    slot."""
    with open(os.path.join(os.path.dirname(native_reply.__file__), "csrc",
                           "reply.cpp")) as f:
        src = f.read()
    return tuple(
        int(re.search(rf"constexpr npy_intp {name} = (\d+);", src).group(1))
        for name in ("kNameAhead", "kSlotAhead"))


NAME_AHEAD, SLOT_AHEAD = prefetch_distances()
# Flat slots where the two stages' read-ahead starts and wraps.
AHEAD_SLOTS = sorted({0, NAME_AHEAD - 1, NAME_AHEAD, NAME_AHEAD + 1,
                      SLOT_AHEAD - 1, SLOT_AHEAD, SLOT_AHEAD + 1,
                      SLOT_AHEAD + NAME_AHEAD})

needs_native = pytest.mark.skipif(
    native_reply.load() is None,
    reason="the reply extension cannot be built here (no g++ or headers)")


@pytest.fixture(params=["native", "python"])
def form(request, monkeypatch):
    """The reply's two forms. "python" is the fallback, as where the
    extension cannot be built: ``native_reply.load()`` gives None."""
    if request.param == "native":
        if native_reply.load() is None:
            pytest.skip("the reply extension cannot be built here")
    else:
        monkeypatch.setattr(native_reply, "_ext", None)
        monkeypatch.setattr(native_reply, "_tried", True)
    return request.param


def name_table(n):
    """An object array of names made at run time (not interned)."""
    return np.array(["".join(("row", str(i))) for i in range(n)], object)


def reply_inputs(rng, b, k, n_names, id_dtype, sim_dtype, holes):
    """Names, [b, k] ids and sims. ``holes``: True for random empty slots
    (id -1 or sim -inf), False for none; at the slots of AHEAD_SLOTS,
    "ahead" puts a negative id there and sim -inf one slot on, "last" the last
    name's id; "strided" and "reversed" read the names through a view of
    step 2 or -1."""
    names = name_table(n_names)
    if holes == "strided":
        names = name_table(2 * n_names)[::2]
    elif holes == "reversed":
        names = names[::-1]
    ids = rng.integers(0, n_names, (b, k)).astype(id_dtype)
    sims = -np.sort(rng.random((b, k)) * 4, axis=1).astype(sim_dtype)
    at = [t for t in AHEAD_SLOTS if t < b * k]
    if holes is True:
        ids[rng.random((b, k)) < 0.15] = -1
        sims[rng.random((b, k)) < 0.15] = NEG_INF
    elif holes == "ahead":  # far below 0 too: a read there would fault
        ids.reshape(-1)[at] = -1
        ids.reshape(-1)[at[1::2]] = np.iinfo(id_dtype).min
        sims.reshape(-1)[[t + 1 for t in at if t + 1 < b * k]] = NEG_INF
    elif holes == "last":
        ids.reshape(-1)[at] = n_names - 1
    return names, ids, sims


def plain_reply(names, ids, sims):
    """The reply's rule written out: (sim as a Python float, the names
    array's own object) of each slot with id >= 0 and sim != -inf."""
    return [
        [(float(s), names[int(i)]) for i, s in zip(row_ids, row_sims)
         if i >= 0 and s != NEG_INF]
        for row_ids, row_sims in zip(ids, sims)
    ]


def columnar_as_plain(names, sims):
    """A columnar reply, [B, k] names (None where empty) and sims, in
    :func:`plain_reply`'s form."""
    return [
        [(float(s), n) for n, s in zip(row_names, row_sims)
         if n is not None and s != NEG_INF]
        for row_names, row_sims in zip(names, sims)
    ]


def assert_reply(got, want):
    assert len(got) == len(want)
    for row, want_row in zip(got, want):
        assert len(row) == len(want_row)
        for r, (sim, name) in zip(row, want_row):
            assert np.float64(r.sim).view(np.int64) == \
                np.float64(sim).view(np.int64)
            assert r.name is name
            assert r.data is None


@pytest.mark.parametrize("id_dtype,sim_dtype", [
    (np.int32, np.float32), (np.int64, np.float32),
    (np.int32, np.float64), (np.int64, np.float64),
])
@pytest.mark.parametrize("shape,holes", [
    ((37, 10), True), ((37, 10), False), ((1, 1), False), ((5, 0), False),
    ((0, 10), False), ((64, 3), True),
    # Replies one shorter than, as long as and one longer than each
    # prefetch distance; then every edge over several distances' slots.
    *(((1, d + e), False) for d in (NAME_AHEAD, SLOT_AHEAD)
      for e in (-1, 0, 1)),
    ((3, SLOT_AHEAD + NAME_AHEAD), "ahead"),
    ((SLOT_AHEAD + NAME_AHEAD, 3), "ahead"),
    ((3, SLOT_AHEAD + NAME_AHEAD), "last"),
    ((3, SLOT_AHEAD + NAME_AHEAD), "strided"),
    ((3, SLOT_AHEAD + NAME_AHEAD), "reversed"),
])
def test_reply_equals_the_plain_rule(form, rng, id_dtype, sim_dtype, shape,
                                     holes):
    names, ids, sims = reply_inputs(rng, *shape, 50, id_dtype, sim_dtype,
                                    holes)
    want = plain_reply(names, ids, sims)
    got = TSE.reply_objects(names, ids, sims)
    assert_reply(got, want)
    assert all(type(r) is TH.result_type() for row in got for r in row)
    assert_reply(TSE.reply_loop(names, ids, sims), want)


@pytest.mark.parametrize("case", ["id_past_the_names", "names_not_objects",
                                  "names_2d", "shapes_differ",
                                  "id_past_the_names_beyond_the_prefetch"])
@needs_native
def test_build_reply_rejects_bad_input(case):
    """Each raises, and leaves the names' refcounts as it found them: the
    results built before an out-of-range id are freed."""
    build = native_reply.load().build_reply
    names = name_table(4)
    ids = np.array([[0, 3]])
    sims = np.array([[-1.0, -2.0]], np.float32)
    # Past the first slots the stages fetch before the loop starts: the
    # read-ahead meets the bad id before the loop does, and skips it.
    n = 2 * (SLOT_AHEAD + NAME_AHEAD)
    far_ids = (np.arange(n) % 4).reshape(2, -1)
    far_ids.reshape(-1)[SLOT_AHEAD + NAME_AHEAD + 1] = 1 << 40
    err, args = {
        "id_past_the_names": (IndexError, (names, ids + 1, sims)),
        "names_not_objects": (TypeError, (np.arange(4), ids, sims)),
        "names_2d": (TypeError, (names.reshape(2, 2), ids, sims)),
        "shapes_differ": (ValueError, (names, ids, sims[:, :1])),
        "id_past_the_names_beyond_the_prefetch": (
            IndexError, (names, far_ids, -np.ones(far_ids.shape))),
    }[case]
    before = refcounts(names)
    with pytest.raises(err):
        build(*args)
    assert refcounts(names) == before


@pytest.mark.parametrize("enabled", [True, False])
@pytest.mark.parametrize("fails", [False, True])
@needs_native
def test_build_reply_gives_the_collector_back(enabled, fails):
    """The call holds the collector off while it runs and leaves it as it
    found it, also where it raises."""
    names = name_table(4)
    ids = np.array([[0, 4 if fails else 3]])
    sims = np.array([[-1.0, -2.0]], np.float32)
    was = gc.isenabled()
    try:
        gc.enable() if enabled else gc.disable()
        if fails:
            with pytest.raises(IndexError):
                native_reply.load().build_reply(names, ids, sims)
        else:
            assert len(native_reply.load().build_reply(names, ids, sims)[0]) \
                == 2
        assert gc.isenabled() is enabled
    finally:
        gc.enable() if was else gc.disable()


def test_result_surface(form):
    R = TH.result_type()
    assert R is T.SearchResult is TH.SearchResult
    assert (R is TH.PySearchResult) == (form == "python")
    a = R(-1.5, "x")
    assert a == R(sim=-1.5, name="x", data=None) == R(-1.5, name="x")
    assert not a != R(-1.5, "x")
    assert a != R(-1.5, "y") and a != R(-2.0, "x") and a != R(-1.5, "x", 1)
    assert a.__eq__((-1.5, "x", None)) is NotImplemented
    assert repr(a) == "SearchResult(sim=-1.5, name='x', data=None)"
    vec = np.arange(3, dtype=np.float32)
    d = R(0.25, "v", vec)
    assert d.data is vec
    assert repr(d) == f"SearchResult(sim=0.25, name='v', data={vec!r})"
    for r in (a, d):
        for twin in (pickle.loads(pickle.dumps(r)), copy.copy(r),
                     copy.deepcopy(r)):
            assert type(twin) is R and twin is not r
            assert (twin.sim, twin.name) == (r.sim, r.name)
            assert np.array_equal(twin.data, r.data) \
                if r.data is not None else twin.data is None
    assert copy.copy(d).data is vec
    with pytest.raises(TypeError):
        R(1.0)
    with pytest.raises(TypeError):
        hash(a)
    assert not hasattr(a, "__dict__")
    with pytest.raises(AttributeError):
        a.other = 1
    a.sim, a.name, a.data = 3, "z", vec
    assert (a.sim, a.name, a.data is vec) == (3.0, "z", True)
    assert R.__match_args__ == ("sim", "name", "data")
    match R(0.5, "m"):
        case R(sim, name, data):
            assert (sim, name, data) == (0.5, "m", None)
        case _:
            pytest.fail("the class pattern did not match")
    # The fallback pickles as itself, also where the native type loaded.
    py = TH.PySearchResult(-1.5, "x")
    twin = pickle.loads(pickle.dumps(py))
    assert type(twin) is TH.PySearchResult and twin == py


def test_result_subclass(form):
    """A subclass keeps the fields, gets a ``__dict__``, prints its own
    name and is always tracked by the collector; copies carry its
    ``__dict__``."""

    class Tagged(TH.result_type()):
        pass

    t = Tagged(0.5, "t")
    t.tag = "extra"
    assert (t.sim, t.name, t.data, t.tag) == (0.5, "t", None, "extra")
    assert repr(t) == f"{Tagged.__qualname__}(sim=0.5, name='t', data=None)"
    assert gc.is_tracked(t)
    t.data = None
    assert gc.is_tracked(t)
    for twin in (copy.copy(t), copy.deepcopy(t)):
        assert type(twin) is Tagged and twin == t and twin.tag == "extra"
    assert t != TH.result_type()(0.5, "t")


@pytest.mark.parametrize("data,tracked", [
    (None, False), (np.zeros(4, np.float32), False),
    (np.zeros(4, np.int32), False), (7, False), ([], True), ({}, True),
])
@needs_native
def test_collector_tracks_only_what_may_cycle(data, tracked):
    R = native_reply.load().SearchResult
    r = R(1.0, "a", data)
    assert gc.is_tracked(r) is tracked
    r.data = None
    assert not gc.is_tracked(r)
    r.data = [1]
    assert gc.is_tracked(r)
    r.data = np.ones(2)
    assert not gc.is_tracked(r)
    r.name = ["a list"]
    assert gc.is_tracked(r)
    r.name = "b"
    assert not gc.is_tracked(r)
    assert gc.is_tracked(R(1.0, ["n"])) and gc.is_tracked(R(1.0, "n", data=[]))


@needs_native
def test_a_cycle_through_a_result_is_collected():
    R = native_reply.load().SearchResult

    class Marker:
        pass

    gone = []
    marker = Marker()
    weakref.finalize(marker, gone.append, 1)
    r = R(1.0, "c")
    r.data = [r, marker]
    assert gc.is_tracked(r)
    del r, marker
    gc.collect()
    assert gone == [1]


def refcounts(names):
    return [sys.getrefcount(n) for n in names]


def test_names_keep_their_refcounts(form, rng):
    names, ids, sims = reply_inputs(rng, 20, 10, 30, np.int32, np.float32,
                                    True)
    before = refcounts(names)
    reply = TSE.reply_objects(names, ids, sims)
    held = sum(len(row) for row in reply)
    assert sum(refcounts(names)) == sum(before) + held
    del reply
    assert refcounts(names) == before


def collections(build):
    """(generations of the collections that ``build()`` and dropping its
    reply set off), from a fresh collector state."""
    assert gc.isenabled()
    seen = []

    def hook(phase, info):
        if phase == "start":
            seen.append(info["generation"])

    gc.collect()
    gc.callbacks.append(hook)
    try:
        reply = build()
        del reply
    finally:
        gc.callbacks.remove(hook)
    return seen


@needs_native
def test_a_large_reply_sets_off_no_full_collection(rng):
    """5,000 x 10: the native reply walks nothing; the loop's 55,000
    tracked objects set off a collection every 700 allocations."""
    names, ids, sims = reply_inputs(rng, 5000, 10, 100_000, np.int32,
                                    np.float32, False)
    native = collections(lambda: TSE.reply_objects(names, ids, sims))
    assert len(native) < 10 and 2 not in native
    assert len(collections(lambda: TSE.reply_loop(names, ids, sims))) > 10


def client_of(rng, kind, n=300, dim=8):
    client = T.HNSW(device="cpu")
    client.create_index("i", dim=dim, kind=kind, m=6, seed=1)
    client.add_batch("i", [f"i{i}" for i in range(n)],
                     rng.standard_normal((n, dim)).astype(np.float32))
    return client


@pytest.mark.parametrize("b", [1, 17])
@pytest.mark.parametrize("kind,engine", [
    ("flat", "auto"), ("hnsw", "scan"), ("hnsw", "graph"),
])
def test_native_reply_queries_counts_each_query(form, rng, b, kind, engine):
    client = client_of(rng, kind)
    qs = rng.standard_normal((b, 8)).astype(np.float32)
    reply = client.search_batch("i", qs, k=5, engine=engine)
    log = client.request_log(1)
    assert log["native_reply_queries"].tolist() == [
        b if form == "native" else 0]
    assert log["queries"].tolist() == [b]
    if kind == "hnsw":  # flat indexes reply with objects alone
        names, sims = client.search_batch("i", qs, k=5, engine=engine,
                                          reply="columnar")
        assert client.request_log(1)["native_reply_queries"].tolist() == [0]
        assert_reply(reply, columnar_as_plain(names, sims))


def test_sharded_reply_is_its_columnar_reply(form, rng):
    data = rng.standard_normal((60, 8)).astype(np.float32)
    idx = ShardedHNSW("sh", T.IndexConfig(dim=8, m=4, ef_construction=32,
                                          seed=1),
                      mesh=make_mesh(3, device="cpu"))
    idx.add_batch([f"s{i}" for i in range(len(data))], data, batch_size=32)
    idx.delete_node("s5")
    qs = np.concatenate([data[:6], rng.standard_normal((6, 8))]).astype(
        np.float32)
    for engine in ("scan", "graph"):
        names, sims = idx.search_batch(qs, k=64, engine=engine,
                                       reply="columnar")
        got = idx.search_batch(qs, k=64, engine=engine)
        want = columnar_as_plain(names, sims)
        assert sum(map(len, want)) < names.size  # empty slots dropped
        assert_reply(got, want)
        assert all(type(r) is TH.result_type() for row in got for r in row)
