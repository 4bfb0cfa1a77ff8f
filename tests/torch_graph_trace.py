"""A recorder of the calls a tracker makes on its host map graph, shared by
`test_torch_native_graph.py` (the trace replayed on the JAX package's
arena) and `torch_loop_cells_reference.py --trace-graph` (the first call
where the two packages part). Not a test module.

`GraphTrace(g, log)` stands in for the graph `g`: every method call and
facade access the tracker makes goes to `g` and is appended to `log` as
(name, args, kwargs, result), arguments and results copied. Facade accesses
are named `pt_alive.get`, `pt_alive.set`, `pt_alive.sum`, `parent.get`,
`parent.set`, `pt_first_kf.get`, `pt_first_kf.set`, `loop_edges.get`,
`loop_edges.add` (one direction, as a caller's `setdefault(a, set())
.add(b)`), `origin_kf.get` and `origin_kf.set`. Calls the graph makes on
itself are not recorded, and neither are the host mirrors (`kf_row`,
`kf_seq`, ...) the callers read as arrays.
"""

import numpy as np

FACADES = ("pt_alive", "pt_first_kf", "parent", "loop_edges")


def copy_value(v):
    """A copy of an argument or result that later writes cannot change."""
    if isinstance(v, np.ndarray):
        return v.copy()
    if isinstance(v, (list, tuple)):
        return type(v)(copy_value(x) for x in v)
    if isinstance(v, set):
        return set(v)
    if isinstance(v, dict):
        return {k: copy_value(x) for k, x in v.items()}
    return v


class _Facade:
    def __init__(self, inner, name, log):
        self._inner, self._name, self._log = inner, name, log

    def _rec(self, op, args, r):
        self._log.append((f"{self._name}.{op}", args, {}, copy_value(r)))

    def __getitem__(self, k):
        r = self._inner[k]
        self._rec("get", (int(k),), r)
        return r

    def __setitem__(self, k, v):
        self._inner[k] = v
        self._rec("set", (int(k), copy_value(v)), None)

    def sum(self):
        r = self._inner.sum()
        self._rec("sum", (), r)
        return r

    def get(self, k, default=None):
        r = self._inner.get(k, default)
        self._rec("get", (int(k),), r)
        return r

    def setdefault(self, k, default):
        inner, rec = self._inner.setdefault(k, default), self._rec

        class _Add:
            def add(self, other):
                inner.add(other)
                rec("add", (int(k), int(other)), None)

        return _Add()


class GraphTrace:
    """A graph with every call the tracker makes on it recorded."""

    def __init__(self, g, log):
        object.__setattr__(self, "_g", g)
        object.__setattr__(self, "_log", log)

    def __getattr__(self, name):
        v = getattr(self._g, name)
        if name in FACADES:
            return _Facade(v, name, self._log)
        if name == "origin_kf":
            self._log.append(("origin_kf.get", (), {}, v))
        elif callable(v):
            def call(*a, **k):
                args, kw = copy_value(a), copy_value(k)
                r = v(*a, **k)
                self._log.append((name, args, kw, copy_value(r)))
                return r
            return call
        return v

    def __setattr__(self, name, value):
        if name == "origin_kf":
            self._log.append(("origin_kf.set", (int(value),), {}, None))
        setattr(self._g, name, value)
