"""The native reply (csrc/reply.cpp): a CPython extension module.

Compiled at first use with ``g++ -O3 -std=c++17 -fPIC -shared`` against
this interpreter's and numpy's headers into ``build/native/`` (see
utils/build.py; the library's name hashes the source, the command and
the two headers that carry the interpreter's and numpy's versions), and
loaded with importlib's extension loader. Nothing outside this package is
read or built. ``load()`` returns None when the compiler or the headers
are missing; the reply then keeps its pure-Python form (models/hnsw.py's
dataclass and ops/search.py's loop), with the same fields and answers.
"""

from __future__ import annotations

import importlib.machinery
import importlib.util
import os
import sysconfig
import threading

from .utils.build import CSRC_DIR, start_build

_SRC = os.path.join(CSRC_DIR, "reply.cpp")
_NAME = "redis_hnsw_tpu_torch._reply"

_lock = threading.Lock()
_ext = None
_tried = False


def build_module(src: str = _SRC):
    """Compile ``src`` (this package's reply.cpp by default; another copy
    of it, for tools/reply_times.py) and load it as a fresh module."""
    loader = importlib.machinery.ExtensionFileLoader(_NAME, _build(src))
    spec = importlib.util.spec_from_loader(_NAME, loader)
    ext = importlib.util.module_from_spec(spec)
    loader.exec_module(ext)
    return ext


def _build(src: str) -> str:
    import numpy as np

    py_inc = sysconfig.get_paths()["include"]
    np_inc = np.get_include()
    headers = [
        os.path.join(py_inc, "patchlevel.h"),
        os.path.join(np_inc, "numpy", "_numpyconfig.h"),
    ]
    _, finish = start_build(
        "native", "reply", [src], headers,
        lambda out: [
            "g++", "-O3", "-std=c++17", "-fPIC", "-shared",
            f"-I{py_inc}", f"-I{np_inc}", "-o", out, src,
        ],
    )
    return finish()


def load():
    """The extension module (``SearchResult``, ``build_reply``), built at
    the first call; None if it cannot be built or loaded."""
    global _ext, _tried
    with _lock:
        if _ext is not None or _tried:
            return _ext
        _tried = True
        try:
            _ext = build_module()
        except (OSError, RuntimeError, ImportError):
            # OSError: no g++ or no header; RuntimeError: the compile
            # failed; ImportError: this interpreter cannot load it.
            _ext = None
        return _ext
