"""Pytest set-up for the whole repository: build the JAX package's host
core (``native/libhnswcore.so``) once, before any test module is
collected.

Test modules of that package call ``redis_hnsw_tpu.native_core.load()``
while they are collected, and ``load()`` runs ``make -C native`` itself
where the library is missing. Under pytest-xdist every worker collects at
once: their ``make`` runs race on one output file, and a worker that
``dlopen``s it half written, or whose ``make`` runs out of time, skips
every native test it runs. ``pytest_configure`` runs in the xdist
controller before any worker starts, and again in each worker, which
then finds the library up to date and only loads it. The build runs
under an exclusive lock on a file under ``build/``, which also
serialises two pytest runs on one tree.

Nothing of either package is imported here: tests/conftest.py must set
JAX's platform before JAX is first imported. Where ``make`` or ``g++`` is
missing this does nothing, and ``load()`` behaves as it would alone.
"""

import fcntl
import os
import shutil
import subprocess

ROOT = os.path.dirname(os.path.abspath(__file__))


def pytest_configure(config):
    if shutil.which("make") is None or shutil.which("g++") is None:
        return
    lock_dir = os.path.join(ROOT, "build")
    os.makedirs(lock_dir, exist_ok=True)
    with open(os.path.join(lock_dir, "native-core.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        # the command redis_hnsw_tpu/native_core.py runs; a failed build
        # leaves the loader to report the library unavailable, as before
        subprocess.run(["make", "-C", os.path.join(ROOT, "native"), "-s"],
                       capture_output=True, check=False)
