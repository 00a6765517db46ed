"""The combining front on an index's lock (api.py ``IndexLock``,
``HNSW.search_batch``), on the CPU at small sizes: searches queued on a
flat index's lock are served as one block, each caller getting the reply
to its own queries; what may join a block and what is served alone;
errors, writes, reentry and interrupted waits; the record's
``block_requests`` and ``block_wait``. One test needs the card and skips
without one:

    python -m pytest --noconftest -q tests/test_torch_coalesce.py
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

import redis_hnsw_tpu_torch as T
from redis_hnsw_tpu_torch import api
from redis_hnsw_tpu_torch.errors import DimensionMismatch
from redis_hnsw_tpu_torch.ops.cuda_scan import TILE
from bench_gpu.reference import euclidean as ref

JOIN_S = 60.0


@pytest.fixture
def rng():
    """The seeded generator of tests/conftest.py, here too, so that the
    file also runs on a card's machine without that conftest."""
    return np.random.default_rng(0)


def flat_client(rng, n=1500, dim=24, device="cpu", kind="flat"):
    data = rng.standard_normal((n, dim)).astype(np.float32)
    client = T.HNSW(device=device)
    client.create_index("f", dim=dim, kind=kind, seed=3)
    client.add_batch("f", [str(i) for i in range(n)], data)
    return client, data


def reply_rows(reply):
    """(ids, sims, names) of a reply, to compare byte for byte."""
    ids = np.array([[int(r.name) for r in res] for res in reply])
    sims = np.array([[r.sim for r in res] for res in reply], np.float32)
    return ids, sims.tobytes(), [[r.name for r in res] for res in reply]


def same(a, b):
    return (np.array_equal(a[0], b[0]) and a[1] == b[1]) and a[2] == b[2]


def wait_for(cond, what):
    t_end = time.monotonic() + JOIN_S
    while not cond():
        assert time.monotonic() < t_end, what
        time.sleep(0.001)


class Queued:
    """Calls started one a thread, each once the one before is queued on
    ``lock`` (held by this thread: ``base`` callers ahead of the first);
    ``results[i]`` is call i's reply or the exception it raised."""

    def __init__(self, lock, calls, base=1):
        self.results = [None] * len(calls)
        self.threads = []
        for i, call in enumerate(calls):
            t = threading.Thread(target=self._run, args=(i, call))
            t.start()
            self.threads.append(t)
            wait_for(lambda: lock._queued == base + i + 1,
                     f"call {i} never queued")

    def _run(self, i, call):
        try:
            self.results[i] = call()
        except BaseException as e:  # noqa: BLE001 -- handed to the test
            self.results[i] = e

    def join(self):
        for t in self.threads:
            t.join(JOIN_S)
        assert not any(t.is_alive() for t in self.threads)
        return self.results


def records(client, n):
    log = client.request_log(n)
    return [{f: int(log[f][i]) for f in log} for i in range(n)]


# -- blocks ---------------------------------------------------------------------

@pytest.mark.parametrize("as_tensor", [False, True])
def test_requests_queued_behind_a_held_lock_are_one_block(rng, as_tensor):
    """Three single-query requests queued while a caller holds the lock
    are served as one block: each record reads ``block_requests`` 3, the
    queries sum to 3 over them, all on the record of the caller that
    served it, and each reply is its query's serial reply."""
    client, _ = flat_client(rng)
    lock = client._index_locks["f"]
    qs = rng.standard_normal((3, 1, 24)).astype(np.float32)
    if as_tensor:
        qs = torch.from_numpy(qs)
    serial = [reply_rows(client.search_batch("f", q, k=5)) for q in qs]
    lock.acquire()
    calls = Queued(lock, [lambda q=q: client.search_batch("f", q, k=5)
                          for q in qs])
    lock.release()
    got = calls.join()
    assert lock._queued == 0
    for g, want in zip(got, serial):
        assert same(reply_rows(g), want)
    recs = records(client, 3)
    assert [r["block_requests"] for r in recs] == [3, 3, 3]
    assert sorted(r["queries"] for r in recs) == [0, 0, 3]
    served = [r for r in recs if r["queries"]]
    assert served[0]["chunks"] == 1 and served[0]["block_wait_ns"] == 0
    assert all(r["block_wait_ns"] > 0 for r in recs if not r["queries"])
    assert all(r["failed"] == 0 for r in recs)


def test_a_lone_caller_is_a_block_of_one(rng):
    client, _ = flat_client(rng)
    for b in (1, 7, TILE + 1):
        client.search_batch("f", rng.standard_normal((b, 24)), k=3)
        (rec,) = records(client, 1)
        assert rec["block_requests"] == 1 and rec["queries"] == b
        assert rec["lock_waiters"] == 0 and rec["block_wait_ns"] == 0


def test_many_clients_get_their_own_replies(rng):
    """32 threads, 20 single-query requests each, switching every
    microsecond: every reply is byte-equal to the serial reply for its
    query and names the reference's top k; every query is counted once,
    on the record of the caller whose block served it; the count of
    callers returns to 0."""
    client, data = flat_client(rng, n=2000, dim=32)
    n_threads, n_req, k = 32, 20, 10
    qs = rng.standard_normal((n_threads, n_req, 32)).astype(np.float32)
    serial = [[reply_rows(client.search_batch("f", q[None], k=k))
               for q in per] for per in qs]
    got = [[None] * n_req for _ in range(n_threads)]
    errors = []

    def send(i):
        try:
            for j, q in enumerate(qs[i]):
                got[i][j] = reply_rows(client.search_batch("f", q[None], k=k))
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(repr(e))

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=send, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(JOIN_S)
    finally:
        sys.setswitchinterval(saved)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert client._index_locks["f"]._queued == 0
    idx, _ = ref.knn(torch.from_numpy(data),
                     torch.from_numpy(qs.reshape(-1, 32)), k)
    want = idx.numpy().reshape(n_threads, n_req, k)
    for i in range(n_threads):
        for j in range(n_req):
            assert same(got[i][j], serial[i][j])
            assert np.array_equal(got[i][j][0][0], want[i, j])
    log = client.request_log(n_threads * n_req)
    assert int(log["queries"].sum()) == n_threads * n_req
    served = log["queries"] > 0
    # a block of m single queries: one record serves m, m records read m
    assert np.array_equal(log["block_requests"][served],
                          log["queries"][served])
    assert int(log["block_requests"].min()) >= 1
    assert log["failed"].sum() == 0


# -- what joins and what is served alone ------------------------------------------

def hnsw_pair(rng):
    client, _ = flat_client(rng, n=300, dim=24, kind="hnsw")
    q = rng.standard_normal((1, 24)).astype(np.float32)
    return client, [lambda: client.search_batch("f", q, k=3)] * 2


def flat_pair(rng, first, second):
    client, _ = flat_client(rng)
    qa = rng.standard_normal((first.pop("b", 1), 24)).astype(np.float32)
    qb = rng.standard_normal((second.pop("b", 1), 24)).astype(np.float32)
    if second.pop("tensor", False):
        qb = torch.from_numpy(qb)
    return client, [
        lambda: client.search_batch("f", qa, **{"k": 3, **first}),
        lambda: client.search_batch("f", qb, **{"k": 3, **second}),
    ]


@pytest.mark.parametrize("case,want", [
    ("equal", 2),
    ("k", 1),
    ("engine", 1),
    ("recall_target", 1),
    ("reply", 1),
    ("host and tensor", 1),
    ("one tile", 2),
    ("above one tile", 1),
    ("above TILE alone", 1),
    ("hnsw", 1),
])
def test_what_joins_a_block(rng, case, want):
    """Two requests queued behind a held lock: one block where they agree
    on k, engine, reply, recall_target and the kind of their queries and
    fit in one query tile of kernel A in all; else each alone. An HNSW
    index serves every request alone."""
    if case == "hnsw":
        client, calls = hnsw_pair(rng)
    else:
        first, second = {
            "equal": ({}, {}),
            "k": ({}, {"k": 4}),
            "engine": ({}, {"engine": "scan-approx"}),
            "recall_target": ({}, {"recall_target": 0.99}),
            "reply": ({}, {"reply": "columnar"}),
            "host and tensor": ({}, {"tensor": True}),
            "one tile": ({"b": 1}, {"b": TILE - 1}),
            "above one tile": ({"b": 2}, {"b": TILE - 1}),
            "above TILE alone": ({"b": 1}, {"b": TILE + 1}),
        }[case]
        client, calls = flat_pair(rng, first, second)
    lock = client._index_locks["f"]
    lock.acquire()
    queued = Queued(lock, calls)
    lock.release()
    got = queued.join()
    assert not any(isinstance(g, BaseException) for g in got), got
    assert lock._queued == 0
    assert [r["block_requests"] for r in records(client, 2)] == [want] * 2


def test_a_hamming_index_joins_only_its_own_requests(rng):
    """A euclidean and a hamming flat index, two requests queued on each:
    each index serves its own two as one block, and each reply is its
    serial reply."""
    client, _ = flat_client(rng)
    words = rng.integers(0, 2**32, (800, 8), dtype=np.uint32)
    client.create_index("h", dim=256, metric="hamming", kind="flat")
    client.add_batch("h", [str(i) for i in range(800)], words)
    qe = rng.standard_normal((2, 1, 24)).astype(np.float32)
    qh = rng.integers(0, 2**32, (2, 1, 8), dtype=np.uint32)
    calls = ([lambda q=q: client.search_batch("f", q, k=4) for q in qe]
             + [lambda q=q: client.search_batch("h", q, k=4) for q in qh])
    serial = [reply_rows(c()) for c in calls]
    lf, lh = client._index_locks["f"], client._index_locks["h"]
    lf.acquire()
    lh.acquire()
    both = Queued(lf, calls[:2])
    ham = Queued(lh, calls[2:])
    lf.release()
    lh.release()
    got = both.join() + ham.join()
    for g, want in zip(got, serial):
        assert same(reply_rows(g), want)
    assert lf._queued == 0 and lh._queued == 0
    recs = records(client, 4)
    assert [r["block_requests"] for r in recs] == [2, 2, 2, 2]
    assert sum(r["queries"] for r in recs) == 4


# -- failures -------------------------------------------------------------------

def test_a_wrong_width_fails_alone_and_the_block_is_answered(rng):
    client, _ = flat_client(rng)
    lock = client._index_locks["f"]
    good = rng.standard_normal((2, 1, 24)).astype(np.float32)
    serial = [reply_rows(client.search_batch("f", q, k=3)) for q in good]
    lock.acquire()
    queued = Queued(lock, [lambda q=q: client.search_batch("f", q, k=3)
                           for q in good])
    with pytest.raises(DimensionMismatch):
        client.search_batch("f", rng.standard_normal((1, 9)), k=3)
    (bad,) = records(client, 1)
    assert bad["failed"] == 1 and bad["queries"] == 0
    assert lock._queued == 3
    lock.release()
    got = queued.join()
    for g, want in zip(got, serial):
        assert same(reply_rows(g), want)
    assert [r["block_requests"] for r in records(client, 2)] == [2, 2]
    assert lock._queued == 0


def test_an_error_of_the_block_reaches_every_member(rng, monkeypatch):
    """The index's search raises inside a block of three: each caller
    gets the error, none hangs, the count returns to 0, and the index
    serves again afterwards."""
    client, _ = flat_client(rng)
    lock = client._index_locks["f"]
    index = client.index("f")

    def broken(*a, **kw):
        raise RuntimeError("card lost")

    monkeypatch.setattr(index, "search_batch", broken)
    q = rng.standard_normal((1, 24)).astype(np.float32)
    lock.acquire()
    queued = Queued(lock, [lambda: client.search_batch("f", q, k=3)] * 3)
    lock.release()
    got = queued.join()
    assert all(isinstance(g, RuntimeError) for g in got), got
    assert lock._queued == 0
    recs = records(client, 3)
    assert [r["failed"] for r in recs] == [1, 1, 1]
    assert [r["block_requests"] for r in recs] == [3, 3, 3]
    monkeypatch.undo()
    assert len(client.search_batch("f", q, k=3)[0]) == 3


# -- writes, reentry, interrupted waits ---------------------------------------------

@pytest.mark.parametrize("write", ["add", "delete"])
def test_a_block_sees_a_write_acknowledged_before_it(rng, write):
    """A write acknowledged while the lock was held is seen by the block
    of searches queued after it."""
    client, data = flat_client(rng)
    lock = client._index_locks["f"]
    v = rng.standard_normal(24).astype(np.float32)
    lock.acquire()
    if write == "add":
        client.add_node("f", "new", v)
        target, want_first = v, "new"
    else:
        client.delete_node("f", "7")
        target, want_first = data[7], None
    queued = Queued(lock, [
        lambda: client.search_batch("f", target[None], k=3),
        lambda: client.search_batch("f", data[:1], k=3),
    ])
    lock.release()
    got = queued.join()
    assert [r["block_requests"] for r in records(client, 2)] == [2, 2]
    names = [r.name for r in got[0][0]]
    if want_first is not None:
        assert names[0] == want_first
    else:
        assert "7" not in names
    assert got[1][0][0].name == "0"


def test_a_reentrant_caller_serves_alone(rng):
    """A thread that holds the lock searches at once, alone, and leaves
    the request queued meanwhile for the next holder."""
    client, _ = flat_client(rng)
    lock = client._index_locks["f"]
    q = rng.standard_normal((1, 24)).astype(np.float32)
    lock.acquire()
    queued = Queued(lock, [lambda: client.search_batch("f", q, k=3)])
    mine = client.search_batch("f", q, k=3)
    (rec,) = records(client, 1)
    assert rec["block_requests"] == 1 and rec["queries"] == 1
    assert lock._queued == 2
    lock.release()
    (theirs,) = queued.join()
    assert same(reply_rows(theirs), reply_rows(mine))
    assert lock._queued == 0


def test_only_the_holder_releases(rng):
    client, _ = flat_client(rng)
    lock = client._index_locks["f"]
    with pytest.raises(RuntimeError):
        lock.release()
    with lock:
        errors = []

        def other():
            try:
                lock.release()
            except RuntimeError as e:
                errors.append(e)

        t = threading.Thread(target=other)
        t.start()
        t.join(JOIN_S)
        assert len(errors) == 1 and lock.owned()
    assert lock._queued == 0 and not lock.owned()


class Interrupt(BaseException):
    pass


class InterruptedWake:
    """A waiter's wake-up whose first wait runs ``meanwhile`` and then
    raises :class:`Interrupt`, as a signal would."""

    def __init__(self, wake, meanwhile):
        self.wake, self.meanwhile, self.first = wake, meanwhile, True

    def acquire(self):
        if self.first:
            self.first = False
            self.meanwhile()
            raise Interrupt
        return self.wake.acquire()

    def release(self):
        self.wake.release()


@pytest.mark.parametrize("when", ["queued", "handed the lock",
                                  "handed the lock and a request",
                                  "taken into a block"])
def test_an_interrupted_wait_leaves_the_lock_sound(rng, when):
    """A caller's wait is interrupted while it is still queued, after the
    lock was handed to it (with or without a request taken into its
    block), or after a holder took its request: it raises, every other
    caller is answered (a request it had taken by the next holder), the
    count returns to 0 and the index serves again."""
    client, _ = flat_client(rng)
    lock = client._index_locks["f"]
    q = rng.standard_normal((1, 24)).astype(np.float32)
    parked, proceed = threading.Event(), threading.Event()
    before, after = [], []
    search = [lambda: client.search_batch("f", q, k=3)]
    if when == "taken into a block":
        before = search
    elif when == "handed the lock and a request":
        after = search

    def interrupted():
        w = api._WAITERS.w
        plain = w.wake

        def meanwhile():
            parked.set()
            assert proceed.wait(JOIN_S)
            if when != "queued":
                wait_for(lambda: w not in lock._waiting, "never taken")
            w.wake = plain

        w.wake = InterruptedWake(plain, meanwhile)
        return client.search_batch("f", q, k=3)

    lock.acquire()
    ahead = Queued(lock, before)
    me = Queued(lock, [interrupted], base=1 + len(before))
    assert parked.wait(JOIN_S)
    behind = Queued(lock, after, base=2 + len(before))
    if when == "queued":
        proceed.set()
        wait_for(lambda: lock._queued == 1, "never left the queue")
        lock.release()
    else:
        lock.release()
        proceed.set()
    (mine,) = me.join()
    assert isinstance(mine, Interrupt)
    for reply in ahead.join() + behind.join():
        assert len(reply[0]) == 3
    wait_for(lambda: lock._queued == 0, "the count never returned to 0")
    assert lock._owner is None and not lock._waiting
    assert len(client.search_batch("f", q, k=3)[0]) == 3


def test_writes_and_searches_take_the_lock_in_arrival_order(rng):
    """A search, a write and a search queued in that order: the first
    search's block takes the second too (it began before the write was
    acknowledged, so it may be served before it), and the write runs
    next, before any later holder."""
    client, _ = flat_client(rng)
    lock = client._index_locks["f"]
    v = rng.standard_normal(24).astype(np.float32)
    order = []
    index = client.index("f")
    plain_add, plain_search = index.add_node, index.search_batch

    def add(*a, **kw):
        order.append("write")
        return plain_add(*a, **kw)

    def search(qs, **kw):
        order.append(("search", len(qs)))
        return plain_search(qs, **kw)

    index.add_node, index.search_batch = add, search
    lock.acquire()
    queued = Queued(lock, [
        lambda: client.search_batch("f", v[None], k=3),
        lambda: client.add_node("f", "new", v),
        lambda: client.search_batch("f", v[None], k=3),
    ])
    lock.release()
    got = queued.join()
    assert order == [("search", 2), "write"]
    assert lock._queued == 0
    assert got[0][0][0].name == got[2][0][0].name != "new"


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_coalesced_replies_on_the_card(card):
    """32 threads of single-query requests on a 65,536 x 960 flat table
    on the card: every reply equals the serial reply for its query; a
    block of at most 32 queries records one 128-lane tile of kernel A;
    32 requests queued behind a held lock are one block."""
    rng = np.random.default_rng(11)
    client, _ = flat_client(rng, n=65536, dim=960, device=card)
    n_threads, n_req = 32, 8
    qs = rng.standard_normal((n_threads, n_req, 1, 960)).astype(np.float32)
    serial = [[reply_rows(client.search_batch("f", q, k=10)) for q in per]
              for per in qs]
    got = [[None] * n_req for _ in range(n_threads)]

    def send(i):
        for j, q in enumerate(qs[i]):
            got[i][j] = reply_rows(client.search_batch("f", q, k=10))

    threads = [threading.Thread(target=send, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads)
    for i in range(n_threads):
        for j in range(n_req):
            assert same(got[i][j], serial[i][j])
    log = client.request_log(n_threads * n_req)
    served = log["queries"] > 0
    assert int(log["queries"].sum()) == n_threads * n_req
    assert set(log["scan_lanes"][served].tolist()) == {128}
    assert int(log["scan_lanes"][~served].sum()) == 0
    assert int(log["block_requests"].max()) > 1
    lock = client._index_locks["f"]
    lock.acquire()
    queued = Queued(lock, [lambda q=q: client.search_batch("f", q, k=10)
                           for q in qs[:, 0]])
    lock.release()
    for g, want in zip(queued.join(), [s[0] for s in serial]):
        assert same(reply_rows(g), want)
    recs = records(client, n_threads)
    assert [r["block_requests"] for r in recs] == [n_threads] * n_threads
    (holder,) = [r for r in recs if r["queries"]]
    assert holder["queries"] == n_threads and holder["scan_lanes"] == 128
    assert lock._queued == 0
