// The object reply of a batched search, built in one native call.
//
// A CPython extension module (`_reply`, built by native_reply.py with g++
// into build/native/) that defines:
//
// * `SearchResult` -- the type of one answer, with the surface of the
//   pure-Python dataclass in models/hnsw.py: fields `sim` (stored as a
//   double), `name` and `data` (default None), all settable; positional and
//   keyword construction; `==`, `repr` and `__match_args__` as the
//   dataclass gives them; no `__dict__`; unhashable; subclassable;
//   pickling and `copy` through `__reduce__`. It is no dataclass:
//   `dataclasses.fields`, `asdict`, `astuple` and `replace` do not take it.
//   The type supports the cycle collector, but follows CPython's rule for
//   dicts: an instance is tracked only while `name` or `data` may take part
//   in a cycle (a GC object other than an untracked tuple). A `str` name
//   and a None or numeric ndarray `data` leave it untracked, so the
//   collector never walks an ordinary reply; the constructor and every
//   setter re-check the rule. Instances of a subclass, which may carry a
//   `__dict__`, are always tracked.
// * `build_reply(names, ids, sims)` -- the per-query lists of results,
//   nearest first, from the object ndarray of row -> name and the [B, k]
//   row ids and similarities: slots with id < 0 or sim == -inf are dropped.
//   Each result's name is the array's own object; its sim is the float
//   widened to a double, as `ndarray.tolist()` gives it. The collector is
//   held off while it runs (on Python 3.10 and 3.11 an allocation past the
//   threshold would collect at once; 3.12 defers that to the call's end),
//   so no collection starts inside the call on any version.

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

struct Result {
  PyObject_HEAD
  double sim;
  PyObject *name;
  PyObject *data;
};

PyTypeObject ResultType = {PyVarObject_HEAD_INIT(nullptr, 0)};

// CPython's own test for a dict's value (_PyObject_GC_MAY_BE_TRACKED):
// an atom or an untracked tuple can hold no reference cycle.
inline bool may_be_tracked(PyObject *o) {
  return PyObject_IS_GC(o) &&
         (!PyTuple_CheckExact(o) || PyObject_GC_IsTracked(o));
}

inline void retrack(Result *self) {
  if (!Py_IS_TYPE(self, &ResultType)) return;  // a subclass: always tracked
  const bool want = may_be_tracked(self->name) || may_be_tracked(self->data);
  const bool is = PyObject_GC_IsTracked(reinterpret_cast<PyObject *>(self));
  if (want && !is) {
    PyObject_GC_Track(self);
  } else if (!want && is) {
    PyObject_GC_UnTrack(self);
  }
}

// A new result holding new references to `name` and `data`; untracked
// unless one of them may be.
PyObject *make(double sim, PyObject *name, PyObject *data) {
  Result *r = PyObject_GC_New(Result, &ResultType);
  if (r == nullptr) return nullptr;
  r->sim = sim;
  r->name = Py_NewRef(name);
  r->data = Py_NewRef(data);
  if (may_be_tracked(name) || may_be_tracked(data)) PyObject_GC_Track(r);
  return reinterpret_cast<PyObject *>(r);
}

PyObject *result_new(PyTypeObject *type, PyObject *args, PyObject *kwds) {
  static const char *kwlist[] = {"sim", "name", "data", nullptr};
  double sim;
  PyObject *name;
  PyObject *data = Py_None;
  if (!PyArg_ParseTupleAndKeywords(args, kwds, "dO|O:SearchResult",
                                   const_cast<char **>(kwlist), &sim, &name,
                                   &data)) {
    return nullptr;
  }
  if (type == &ResultType) return make(sim, name, data);
  // A subclass: its own allocator, which tracks the instance.
  Result *r = reinterpret_cast<Result *>(type->tp_alloc(type, 0));
  if (r == nullptr) return nullptr;
  r->sim = sim;
  r->name = Py_NewRef(name);
  r->data = Py_NewRef(data);
  return reinterpret_cast<PyObject *>(r);
}

void result_dealloc(PyObject *o) {
  Result *self = reinterpret_cast<Result *>(o);
  PyObject_GC_UnTrack(o);
  Py_CLEAR(self->name);
  Py_CLEAR(self->data);
  Py_TYPE(o)->tp_free(o);
}

int result_traverse(PyObject *o, visitproc visit, void *arg) {
  Result *self = reinterpret_cast<Result *>(o);
  Py_VISIT(self->name);
  Py_VISIT(self->data);
  return 0;
}

int result_clear(PyObject *o) {
  Result *self = reinterpret_cast<Result *>(o);
  Py_SETREF(self->name, Py_NewRef(Py_None));
  Py_SETREF(self->data, Py_NewRef(Py_None));
  return 0;
}

// The dataclass's __eq__: (sim, name, data) compared as tuples, for two
// results of this type; NotImplemented otherwise.
PyObject *fields(Result *r) {
  return Py_BuildValue("(dOO)", r->sim, r->name, r->data);
}

PyObject *result_richcompare(PyObject *a, PyObject *b, int op) {
  if ((op != Py_EQ && op != Py_NE) || Py_TYPE(a) != Py_TYPE(b)) {
    Py_RETURN_NOTIMPLEMENTED;
  }
  PyObject *ta = fields(reinterpret_cast<Result *>(a));
  if (ta == nullptr) return nullptr;
  PyObject *tb = fields(reinterpret_cast<Result *>(b));
  if (tb == nullptr) {
    Py_DECREF(ta);
    return nullptr;
  }
  PyObject *out = PyObject_RichCompare(ta, tb, op);
  Py_DECREF(ta);
  Py_DECREF(tb);
  return out;
}

// Named by the class's __qualname__, as the dataclass's repr is.
PyObject *result_repr(PyObject *o) {
  Result *self = reinterpret_cast<Result *>(o);
  const int busy = Py_ReprEnter(o);
  if (busy != 0) return busy > 0 ? PyUnicode_FromString("...") : nullptr;
  PyObject *out = nullptr;
  PyObject *qualname = PyObject_GetAttrString(
      reinterpret_cast<PyObject *>(Py_TYPE(o)), "__qualname__");
  PyObject *sim = PyFloat_FromDouble(self->sim);
  if (qualname != nullptr && sim != nullptr) {
    out = PyUnicode_FromFormat("%S(sim=%R, name=%R, data=%R)", qualname, sim,
                               self->name, self->data);
  }
  Py_XDECREF(qualname);
  Py_XDECREF(sim);
  Py_ReprLeave(o);
  return out;
}

// (type, (sim, name, data)), and a subclass instance's __dict__ as the
// state where it has one.
PyObject *result_reduce(PyObject *o, PyObject *) {
  Result *self = reinterpret_cast<Result *>(o);
  PyObject *args = Py_BuildValue("(dOO)", self->sim, self->name, self->data);
  if (args == nullptr) return nullptr;
  PyObject *dict = nullptr;
  if (!Py_IS_TYPE(o, &ResultType)) {
    dict = PyObject_GetAttrString(o, "__dict__");
    if (dict == nullptr) {
      if (!PyErr_ExceptionMatches(PyExc_AttributeError)) {
        Py_DECREF(args);
        return nullptr;
      }
      PyErr_Clear();  // a subclass with __slots__ and no __dict__
    }
  }
  PyObject *out = dict != nullptr && PyDict_Check(dict) && PyDict_Size(dict)
                      ? Py_BuildValue("(OOO)", Py_TYPE(o), args, dict)
                      : Py_BuildValue("(OO)", Py_TYPE(o), args);
  Py_XDECREF(dict);
  Py_DECREF(args);
  return out;
}

PyObject *get_sim(PyObject *o, void *) {
  return PyFloat_FromDouble(reinterpret_cast<Result *>(o)->sim);
}

int set_sim(PyObject *o, PyObject *v, void *) {
  if (v == nullptr) {
    PyErr_SetString(PyExc_TypeError, "cannot delete SearchResult.sim");
    return -1;
  }
  const double d = PyFloat_AsDouble(v);
  if (d == -1.0 && PyErr_Occurred()) return -1;
  reinterpret_cast<Result *>(o)->sim = d;
  return 0;
}

// `name` and `data`: the closure is the field's offset in Result.
PyObject **field(PyObject *o, void *closure) {
  const auto offset = reinterpret_cast<std::ptrdiff_t>(closure);
  return reinterpret_cast<PyObject **>(reinterpret_cast<char *>(o) + offset);
}

PyObject *get_field(PyObject *o, void *closure) {
  return Py_NewRef(*field(o, closure));
}

int set_field(PyObject *o, PyObject *v, void *closure) {
  if (v == nullptr) {
    PyErr_SetString(PyExc_TypeError, "cannot delete a SearchResult field");
    return -1;
  }
  PyObject *old = *field(o, closure);
  *field(o, closure) = Py_NewRef(v);
  retrack(reinterpret_cast<Result *>(o));
  Py_DECREF(old);
  return 0;
}

PyGetSetDef result_getset[] = {
    {"sim", get_sim, set_sim, "similarity (negative squared L2, or the "
     "hamming score)", nullptr},
    {"name", get_field, set_field, "the row's name",
     reinterpret_cast<void *>(offsetof(Result, name))},
    {"data", get_field, set_field, "the row's vector (single-query replies) "
     "or None", reinterpret_cast<void *>(offsetof(Result, data))},
    {nullptr, nullptr, nullptr, nullptr, nullptr},
};

PyMethodDef result_methods[] = {
    {"__reduce__", result_reduce, METH_NOARGS, nullptr},
    {nullptr, nullptr, 0, nullptr},
};

// Each answer costs two dependent cache misses: its slot of the names array
// (8 bytes a row, read at random) and then the name object that slot points
// to, whose refcount Py_NewRef writes. Every id is known before the first
// answer is built, so `build` fetches both ahead, over the flattened
// [n_rows * k] slots: at slot t, the names-array slot of slot t + kSlotAhead
// and the name object of slot t + kNameAhead, whose names-array slot the
// first stage has already brought in. Distances in slots, from a sweep on
// the card's host (PERF.md §5).
constexpr npy_intp kSlotAhead = 64;
constexpr npy_intp kNameAhead = 32;

// The lists of one reply: per row of ids / sims ([n_rows, k], C order),
// a result for each slot with id >= 0 and sim != -inf (NaN is kept), in
// slot order -- the rule of the Python loop in ops/search.py.
PyObject *build(PyArrayObject *names, const std::int64_t *ids,
                const double *sims, npy_intp n_rows, npy_intp k) {
  const npy_intp n_names = PyArray_DIM(names, 0);
  const npy_intp stride = PyArray_STRIDE(names, 0);
  const char *base = PyArray_BYTES(names);
  const npy_intp n_slots = n_rows * k;
  // The names-array slot of flat slot t; nullptr where its id is out of
  // range (the main loop skips or rejects that slot).
  auto slot = [&](npy_intp t) -> PyObject *const * {
    const std::int64_t id = ids[t];
    if (id < 0 || id >= n_names) return nullptr;
    return reinterpret_cast<PyObject *const *>(base + id * stride);
  };
  // Inlined by force: GCC takes a function whose only effect is a prefetch
  // for one with no effect, and drops the calls.
  auto fetch_slot = [&](npy_intp t) __attribute__((always_inline)) {
    if (PyObject *const *s = slot(t)) __builtin_prefetch(s);
  };
  auto fetch_name = [&](npy_intp t) __attribute__((always_inline)) {
    if (PyObject *const *s = slot(t)) {
      if (*s != nullptr) __builtin_prefetch(*s, 1);
    }
  };
  for (npy_intp t = 0; t < std::min(kSlotAhead, n_slots); ++t) fetch_slot(t);
  for (npy_intp t = 0; t < std::min(kNameAhead, n_slots); ++t) fetch_name(t);
  PyObject *out = PyList_New(n_rows);
  if (out == nullptr) return nullptr;
  for (npy_intp b = 0; b < n_rows; ++b) {
    const std::int64_t *row_ids = ids + b * k;
    const double *row_sims = sims + b * k;
    npy_intp kept = 0;
    for (npy_intp j = 0; j < k; ++j) {
      kept += row_ids[j] >= 0 && row_sims[j] != -INFINITY;
    }
    PyObject *row = PyList_New(kept);
    if (row == nullptr) {
      Py_DECREF(out);
      return nullptr;
    }
    PyList_SET_ITEM(out, b, row);
    npy_intp at = 0;
    for (npy_intp j = 0; j < k; ++j) {
      const npy_intp t = b * k + j;
      if (t + kSlotAhead < n_slots) fetch_slot(t + kSlotAhead);
      if (t + kNameAhead < n_slots) fetch_name(t + kNameAhead);
      const std::int64_t id = row_ids[j];
      if (id < 0 || row_sims[j] == -INFINITY) continue;
      if (id >= n_names) {
        PyErr_Format(PyExc_IndexError,
                     "row id %lld is out of bounds for %lld names",
                     static_cast<long long>(id),
                     static_cast<long long>(n_names));
        Py_DECREF(out);
        return nullptr;
      }
      PyObject *name =
          *reinterpret_cast<PyObject *const *>(base + id * stride);
      PyObject *r = make(row_sims[j], name == nullptr ? Py_None : name,
                         Py_None);
      if (r == nullptr) {
        Py_DECREF(out);
        return nullptr;
      }
      PyList_SET_ITEM(row, at++, r);
    }
  }
  return out;
}

PyObject *build_reply(PyObject *, PyObject *args) {
  PyObject *names_o, *ids_o, *sims_o;
  if (!PyArg_ParseTuple(args, "OOO:build_reply", &names_o, &ids_o, &sims_o)) {
    return nullptr;
  }
  if (!PyArray_Check(names_o) ||
      PyArray_TYPE(reinterpret_cast<PyArrayObject *>(names_o)) != NPY_OBJECT ||
      PyArray_NDIM(reinterpret_cast<PyArrayObject *>(names_o)) != 1) {
    PyErr_SetString(PyExc_TypeError,
                    "build_reply: names must be a 1-D object ndarray");
    return nullptr;
  }
  // Read as int64 / float64 (copies where the dtype differs): both hold
  // every int32 id and float32 sim exactly, as tolist() widens them.
  auto *ids = reinterpret_cast<PyArrayObject *>(
      PyArray_FROMANY(ids_o, NPY_INT64, 2, 2, NPY_ARRAY_IN_ARRAY));
  if (ids == nullptr) return nullptr;
  auto *sims = reinterpret_cast<PyArrayObject *>(
      PyArray_FROMANY(sims_o, NPY_FLOAT64, 2, 2, NPY_ARRAY_IN_ARRAY));
  if (sims == nullptr) {
    Py_DECREF(ids);
    return nullptr;
  }
  PyObject *out = nullptr;
  const npy_intp n_rows = PyArray_DIM(ids, 0), k = PyArray_DIM(ids, 1);
  if (PyArray_DIM(sims, 0) != n_rows || PyArray_DIM(sims, 1) != k) {
    PyErr_SetString(PyExc_ValueError,
                    "build_reply: ids and sims differ in shape");
  } else {
    const int was_enabled = PyGC_Disable();
    out = build(reinterpret_cast<PyArrayObject *>(names_o),
                static_cast<const std::int64_t *>(PyArray_DATA(ids)),
                static_cast<const double *>(PyArray_DATA(sims)), n_rows, k);
    if (was_enabled) PyGC_Enable();
  }
  Py_DECREF(ids);
  Py_DECREF(sims);
  return out;
}

PyMethodDef module_methods[] = {
    {"build_reply", build_reply, METH_VARARGS,
     "build_reply(names, ids, sims) -> list of lists of SearchResult"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module_def = {
    PyModuleDef_HEAD_INIT, "_reply",
    "SearchResult and build_reply, a batch reply in one call.", -1,
    module_methods, nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__reply(void) {
  import_array();
  ResultType.tp_name = "redis_hnsw_tpu_torch.models.hnsw.SearchResult";
  ResultType.tp_basicsize = sizeof(Result);
  ResultType.tp_flags =
      Py_TPFLAGS_DEFAULT | Py_TPFLAGS_BASETYPE | Py_TPFLAGS_HAVE_GC;
  ResultType.tp_doc =
      "SearchResult(sim, name, data=None): one answer of a search.";
  ResultType.tp_new = result_new;
  ResultType.tp_dealloc = result_dealloc;
  ResultType.tp_traverse = result_traverse;
  ResultType.tp_clear = result_clear;
  ResultType.tp_richcompare = result_richcompare;
  ResultType.tp_hash = PyObject_HashNotImplemented;
  ResultType.tp_repr = result_repr;
  ResultType.tp_getset = result_getset;
  ResultType.tp_methods = result_methods;
  if (PyType_Ready(&ResultType) < 0) return nullptr;
  PyObject *match_args = Py_BuildValue("(sss)", "sim", "name", "data");
  if (match_args == nullptr ||
      PyDict_SetItemString(ResultType.tp_dict, "__match_args__", match_args) <
          0) {
    Py_XDECREF(match_args);
    return nullptr;
  }
  Py_DECREF(match_args);
  PyType_Modified(&ResultType);
  PyObject *m = PyModule_Create(&module_def);
  if (m == nullptr) return nullptr;
  if (PyModule_AddObjectRef(m, "SearchResult",
                            reinterpret_cast<PyObject *>(&ResultType)) < 0) {
    Py_DECREF(m);
    return nullptr;
  }
  return m;
}
