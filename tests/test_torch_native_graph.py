"""The C++ map-graph arena on the port (`native.py`, built from
`csrc/map_graph.cpp`) against the JAX package's arena (its `native.py` over
`native/libmapgraph.so`) and against the port's Python `MapGraph`.

- The port's source is the JAX package's byte for byte.
- Random operation sequences (slots allocated past capacity so that they
  recycle, observations added and erased, `update_connections`,
  `covis_neighbors` with ties, point and keyframe kills with re-parenting,
  loop edges, `apply_fuse` with a merge chain, the refresh export,
  `redundant_obs`, `young_points`): the port's arena returns exactly what
  JAX's returns, call by call, and the final exports are equal. The
  port's Python graph returns the same results as sets. What may differ
  there is order and what ties decide: `obs_pairs`, `points_with_obs`,
  `loop_edges.get`, the refresh export's observer order, the order of
  equal covisibility weights, and the parents re-parenting picks when a
  culled keyframe had several children. The sequences keep one most-shared
  keyframe at every `update_connections`, so the parent and the single
  fallback link do not depend on a tie.
- The tie order itself, `apply_fuse`'s output-capacity cut, the
  tracker's graph (the Python one: the arena is held from it until cell
  F's loop gate holds on it on the H100, ROADMAP.md A1), a build that
  fails, and map files across the two graphs.
- A trace replay: the port tracks the 20-frame QVGA clip of
  `test_torch_tracking_lba.py` on the arena with local BA on; every graph
  call it makes, with its arguments and result, is replayed on JAX's
  arena, which must return the same.
"""

import filecmp
import os
import re
from collections import Counter

import numpy as np
import pytest
import torch

from orb_slam2_refactored_tpu import native as jax_native
from orb_slam2_refactored_tpu.slam.map_state import MapCapacity as JCap
from orb_slam2_refactored_tpu_torch import native
from orb_slam2_refactored_tpu_torch.io.synthetic import (
    SyntheticScene, box_room, orbit_trajectory)
from orb_slam2_refactored_tpu_torch.slam import tracking
from orb_slam2_refactored_tpu_torch.slam.map_state import MapCapacity, MapGraph
from orb_slam2_refactored_tpu_torch.slam.serialize import load_map, save_map
from torch_graph_trace import GraphTrace, copy_value

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the port's names that the JAX arena spells otherwise
JAX_NAMES = {"covis_w": "covis_weight"}


def test_source_is_the_jax_packages_byte_for_byte():
    assert filecmp.cmp(native.SOURCE,
                       os.path.join(ROOT, "native", "map_graph.cpp"),
                       shallow=False)
    assert "-march=native" not in native.FLAGS
    assert native.library_path().startswith(native.BUILD_DIR)
    assert os.path.basename(native.library_path()) != "libmapgraph.so"


# -- the same call on three graphs ---------------------------------------

def _invoke(g, name, args, kw=None):
    """One graph call: a method (the JAX arena's spelling where it
    differs), or a facade access `pt_alive.get`, `parent.set`,
    `pt_alive.sum`, `origin_kf.get`, `loop_edges.get`, `loop_edges.add`
    (one direction, as a caller's `setdefault(a, set()).add(b)`)."""
    facade, _, op = name.partition(".")
    if not op:
        if isinstance(g, jax_native.NativeMapGraph):
            name = JAX_NAMES.get(name, name)
        return getattr(g, name)(*args, **(kw or {}))
    if facade == "origin_kf":
        if op == "set":
            g.origin_kf = args[0]
            return None
        return int(g.origin_kf)
    obj = getattr(g, facade)
    if facade == "loop_edges":
        if op == "add":
            return obj.setdefault(args[0], set()).add(args[1])
        return obj.get(args[0], set())
    if op == "sum":
        return int(obj.sum())
    if op == "set":
        obj[args[0]] = args[1]
        return None
    r = obj[args[0]]
    return bool(r) if facade == "pt_alive" else int(r)


def _same(a, b):
    """Exact equality of results: numpy arrays, lists, tuples, scalars."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and np.array_equal(a, b)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def _refresh_rows(res):
    pts, okf, oft, nob, n = res
    return {int(pts[i]): sorted(zip(okf[i, :nob[i]].tolist(),
                                    oft[i, :nob[i]].tolist()))
            for i in range(n)}


class Trio:
    """The port's arena, JAX's arena and the port's Python graph, driven by
    the same calls. Arguments given as a function of the graph (a row of
    its own `kf_row` mirror) are evaluated for each graph."""

    def __init__(self, K, P, N):
        self.port = native.NativeMapGraph(MapCapacity(K, P, N))
        self.jax = jax_native.NativeMapGraph(JCap(K, P, N))
        self.py = MapGraph(MapCapacity(K, P, N))
        self.tree_exact = True
        self.calls = Counter()

    def call(self, name, *args):
        self.calls[name] += 1
        out = []
        for g in (self.port, self.jax, self.py):
            out.append(_invoke(g, name, [x(g) if callable(x) else x
                                         for x in args]))
        r, rj, rp = out
        assert _same(r, rj), (name, args, r, rj)
        self._check_python(name, args, r, rp)
        self._check_mirrors()
        return r

    def _check_python(self, name, args, r, rp):
        if name in ("obs_pairs", "points_with_obs", "kill_point"):
            assert sorted(r) == sorted(rp), (name, args)
        elif name == "loop_edges.get":
            assert set(r) == set(rp), (name, args)
        elif name == "covis_neighbors":
            # equal weights may come in another order, and top_k may cut
            # between them
            w = [self.port.covis_w(args[0], j) for j in r]
            wp = [self.py.covis_w(args[0], j) for j in rp]
            assert w == wp, (name, args)
            last = w[-1] if w else None
            assert ({j for j, x in zip(r, w) if x != last}
                    == {j for j, x in zip(rp, wp) if x != last}), args
            if not args[2:] or not args[2]:
                assert set(r) == set(rp), (name, args)
        elif name == "refresh_export":
            pts, _, _, nob, n = r
            assert n == rp[4] and _same(pts[:n], rp[0][:n])
            assert _same(nob[:n], rp[3][:n])
            full = {p for p in pts[:n].tolist() if self.port.n_obs(p) <= args[2]}
            a, b = _refresh_rows(r), _refresh_rows(rp)
            assert {p: a[p] for p in full} == {p: b[p] for p in full}
        elif name == "parent.get":
            if self.tree_exact:
                assert r == rp, (name, args)
        elif name == "pt_alive.sum":
            assert r == rp
        else:
            assert _same(r, rp), (name, args, r, rp)

    def _check_mirrors(self):
        # the port's numpy mirror of the point flags is the arena's
        assert np.array_equal(self.port.pt_alive.flags,
                              self.port.arena_pt_alive())
        for g in (self.jax, self.py):
            assert np.array_equal(self.port.kf_row, g.kf_row)
            assert np.array_equal(self.port.kf_alive, g.kf_alive)
            assert np.array_equal(self.port.kf_seq, g.kf_seq)
            assert (self.port.num_kfs, self.port.next_point,
                    self.port.next_kf_slot) == (g.num_kfs, g.next_point,
                                                g.next_kf_slot)
            assert self.port.pt_quarantine == g.pt_quarantine
            assert self.port.kf_quarantine == g.kf_quarantine
            assert self.port.young_pts == g.young_pts

    # -- what the callers do, built from the calls above ---------------------

    def counter(self, kf, row):
        """update_connections' shared-point counts (the Python graph's)."""
        c = Counter()
        for pt in row:
            if pt >= 0 and self.py.pt_alive[pt]:
                for other in self.py.obs.get(int(pt), {}):
                    if other != kf and self.py.kf_alive[other]:
                        c[other] += 1
        return c

    def update_connections(self, kf, wire=True):
        """`update_connections` with one most-shared keyframe: a tie at the
        top is broken first by erasing observations of `kf`."""
        while True:
            c = self.counter(kf, self.port.kf_row[kf])
            top = sorted(c.values(), reverse=True)[:2]
            if len(top) < 2 or top[0] != top[1]:
                break
            tied = sorted(j for j, n in c.items() if n == top[0])
            pt = next(int(p) for p in self.port.kf_row[kf]
                      if p >= 0 and self.port.pt_alive[int(p)]
                      and self.port.obs_feat_in_kf(int(p), tied[0]) >= 0)
            self.call("erase_observation", pt, kf)
        self.call("update_connections", kf, lambda g: g.kf_row[kf].copy(),
                  wire)

    def kill_keyframe(self, kf):
        """`LocalMapper.cull_keyframes` and `kill_orphan_points`: detach the
        observations, kill the keyframe, kill points left with < 2."""
        if len(self.py.children.get(kf, ())) > 1:
            # re-parenting walks the children in the container's order
            self.tree_exact = False
        row = self.port.kf_row[kf].copy()
        for f in np.nonzero(row >= 0)[0]:
            self.call("erase_observation", int(row[f]), kf)
        self.call("parent.get", kf)
        self.call("kill_keyframe", kf)
        for pt in sorted(set(row[row >= 0].tolist())):
            if self.call("pt_alive.get", pt) and self.call("n_obs", pt) < 2:
                self.call("kill_point", pt)

def _graph_content(g):
    """(observations, covisibility weights, loop edges, parents, live
    points) of a graph, each in a fixed order."""
    w = getattr(g, "covis_w", None) or g.covis_weight
    obs = sorted((p, kf, ft) for p in g.points_with_obs()
                 for kf, ft in g.obs_pairs(p))
    covis = sorted((int(a), b, w(int(a), b))
                   for a in g.alive_kfs() for b in g.covis_neighbors(int(a)))
    loops = sorted((int(a), b) for a in g.alive_kfs()
                   for b in g.loop_edges.get(int(a), set()))
    parents = [int(g.parent[k]) for k in range(g.cap.max_keyframes)]
    return obs, covis, loops, parents, g.alive_points().tolist()


def _alive_kfs(t):
    return [int(k) for k in t.port.alive_kfs()]


def _new_keyframe(t, rng, N):
    s = t.call("alloc_kf_slot")
    t.call("set_kf_alive", s, True)
    t.call("set_levels", s, rng.integers(0, 4, N).astype(np.int32))
    if t.call("origin_kf.get") < 0:
        t.call("origin_kf.set", s)
    feats = rng.permutation(N)
    # old points: those of the newest alive keyframes first
    recent = [k for k in sorted(_alive_kfs(t), key=lambda k: -t.port.kf_seq[k])
              if k != s][:3]
    old = sorted({int(p) for k in recent for p in t.port.kf_row[k] if p >= 0})
    n_old = min(len(old), int(rng.integers(18, 30)), N // 2)
    olds = rng.choice(old, n_old, replace=False) if n_old else []
    news = t.call("alloc_point_slots", int(rng.integers(6, 14)))
    for p in news:
        t.call("pt_alive.set", int(p), True)
        t.call("note_new_point", int(p), s)
    for f, p in zip(feats, list(olds) + [int(p) for p in news]):
        t.call("add_observation", int(p), s, int(f), False)
    t.update_connections(s)
    return s


def _fuse_args(t, rng, new_kf, N):
    """Decisions as `_fuse_pair_impl` makes them: pairs (new, nb) and
    (nb, new), each kept feature's destination feature taken once a
    destination keyframe."""
    nbs = t.port.covis_neighbors(new_kf, 0, 3)
    pairs = [(new_kf, nb) for nb in nbs] + [(nb, new_kf) for nb in nbs]
    pairs += [(new_kf, new_kf)]  # a padding row
    B = len(pairs)
    idx = np.full((B, N), -1, np.int32)
    dst_pt = np.full((B, N), -1, np.int32)
    keep = np.zeros((B, N), bool)
    src_mp = np.full((B, N), -1, np.int32)
    taken = {}
    for bi, (a, b) in enumerate(pairs):
        src_mp[bi] = t.port.kf_row[a]
        free = taken.setdefault(b, list(rng.permutation(N)))
        for f in np.nonzero(src_mp[bi] >= 0)[0]:
            if rng.random() < 0.3 and free and a != b:
                fd = int(free.pop())
                idx[bi, f], keep[bi, f] = fd, True
                dst_pt[bi, f] = t.port.kf_row[b, fd]
    return (np.asarray([a for a, _ in pairs], np.int32),
            np.asarray([b for _, b in pairs], np.int32), idx, dst_pt, keep,
            src_mp)


def _merge_chain(t, N):
    """X merges into Y, then Y into Z: X's merge resolves to Z."""
    alive = [int(p) for p in t.port.alive_points() if t.port.n_obs(int(p)) > 0]
    alive.sort(key=lambda p: (t.port.n_obs(p), p))
    x, y = alive[0], alive[1]
    z = alive[-1]
    assert t.port.n_obs(z) >= t.port.n_obs(x) + t.port.n_obs(y), "no chain"
    kx = t.port.obs_pairs(x)[0][0]
    idx = np.zeros((2, N), np.int32)
    dst_pt = np.full((2, N), -1, np.int32)
    keep = np.zeros((2, N), bool)
    src_mp = np.full((2, N), -1, np.int32)
    src_mp[0, 0], dst_pt[0, 0], keep[0, 0] = x, y, True
    src_mp[1, 0], dst_pt[1, 0], keep[1, 0] = y, z, True
    other = next(k for k in _alive_kfs(t) if k != kx)
    res = t.call("apply_fuse", np.asarray([kx, other], np.int32),
                 np.asarray([other, kx], np.int32), idx, dst_pt, keep, src_mp)
    (_, _, _), (m_src, m_dst), killed = res
    assert m_src.tolist() == [x, y] and m_dst.tolist() == [z, z]
    assert killed.tolist() == [x, y]


@pytest.mark.parametrize("seed", range(6))
def test_random_sequences_match_jax_arena_call_by_call(seed):
    K, P, N = 10, 160, 48
    rng = np.random.default_rng(seed)
    t = Trio(K, P, N)
    s = _new_keyframe(t, rng, N)
    chain_at = int(rng.integers(8, 14))
    for step in range(26):
        if len(_alive_kfs(t)) >= K - 4:
            # cull one, as the mapper does; its slot ages in quarantine
            # (3 keyframe creations) before it is recycled
            cands = [k for k in _alive_kfs(t)
                     if k != t.port.origin_kf and k != s]
            t.kill_keyframe(int(rng.choice(cands)))
        assert t.call("can_alloc_kf")
        s = _new_keyframe(t, rng, N)
        kfs = _alive_kfs(t)
        if step == chain_at:
            _merge_chain(t, N)
        if rng.random() < 0.7:
            t.call("apply_fuse", *_fuse_args(t, rng, s, N))
            t.update_connections(s)
        for kf in kfs:
            t.call("covis_neighbors", kf, int(rng.choice([0, 15])),
                   int(rng.choice([0, 2, 3])))
            t.call("parent.get", kf)
        pts = [int(p) for p in t.port.alive_points()]
        for p in rng.choice(pts, min(6, len(pts)), replace=False):
            p = int(p)
            pairs = t.call("obs_pairs", p)
            t.call("n_obs", p)
            t.call("pt_first_kf.get", p)
            if pairs:
                kf = sorted(pairs)[0][0]
                t.call("obs_feat_in_kf", p, kf)
                if rng.random() < 0.3:
                    t.call("erase_observation", p, kf)
        if pts and rng.random() < 0.5:
            t.call("kill_point", int(rng.choice(pts)))
        if len(kfs) > 2 and rng.random() < 0.4:
            a, b = (int(k) for k in rng.choice(kfs, 2, replace=False))
            t.call("loop_edges.add", a, b)
            t.call("loop_edges.add", b, a)
        for kf in kfs:
            t.call("loop_edges.get", kf)
        kf = int(rng.choice(kfs))
        for M in (8, K):
            t.call("refresh_export", lambda g: g.kf_row[kf].copy(), 2, M, 64)
        t.call("redundant_obs", kf, lambda g: g.kf_row[kf].copy(),
               lambda g: g.kf_levels)
        seq = t.port.num_kfs - 1
        t.call("young_points", seq, 3)
        t.call("young_points", seq, 2)
        if len(kfs) > 5 and rng.random() < 0.3:
            cands = [k for k in kfs if k != t.port.origin_kf and k != s]
            t.kill_keyframe(int(rng.choice(cands)))
        t.call("points_with_obs")
        t.call("alive_points")
        t.call("alive_kfs")
        t.call("pt_alive.sum")
    # recycling happened, and every kind of call was made
    assert t.port.num_kfs > K and t.port.recycled_log
    for name in ("apply_fuse", "kill_keyframe", "kill_point",
                 "erase_observation", "refresh_export", "loop_edges.add"):
        assert t.calls[name] > 0, name
    e_port, e_jax, e_py = (_graph_content(g) for g in (t.port, t.jax, t.py))
    assert e_port == e_jax
    for a, b, name in zip(e_port, e_py, ("obs", "covis", "loops", "parents",
                                         "alive")):
        if name != "parents" or t.tree_exact:
            assert a == b, name
    # the raw orders too, call for call equal to JAX's arena
    assert t.port.points_with_obs() == t.jax.points_with_obs()


def test_covisibility_ties_lowest_keyframe_first_on_the_arena():
    """Keyframe 0 shares 20 points with each of 3, 1 and 2, met in that
    order: the arena returns [1, 2, 3], the Python graph [3, 1, 2]."""
    cap = MapCapacity(4, 64, 64)
    graphs = [native.NativeMapGraph(cap), MapGraph(cap)]
    for g in graphs:
        for k in range(4):
            g.set_kf_alive(k, True)
        f = 0
        for k in (3, 1, 2):
            for _ in range(20):
                g.pt_alive[f] = True
                g.add_observation(f, 0, f, False)
                g.add_observation(f, k, f, False)
                f += 1
        g.update_connections(0, g.kf_row[0].copy())
    arena, py = graphs
    assert arena.covis_neighbors(0) == [1, 2, 3]
    assert py.covis_neighbors(0) == [3, 1, 2]
    assert arena.covis_neighbors(0, top_k=2) == [1, 2]
    assert [arena.covis_w(0, k) for k in (1, 2, 3)] == [20, 20, 20]


def _overflow_graph(g):
    """600 points X (3 observations: keyframes 0-2) each duplicating a point
    Y (3 observations: keyframes 1-3): 600 merges of 3 mirror updates, past
    the 1,200 updates `apply_fuse` has room for."""
    for k in range(4):
        g.set_kf_alive(k, True)
    for i in range(600):
        x, y = i, 600 + i
        for p, kfs in ((x, (0, 1, 2)), (y, (1, 2, 3))):
            g.pt_alive[p] = True
            for k in kfs:
                g.add_observation(p, k, p, False)
    src = np.arange(600, dtype=np.int32)[None]
    return (np.asarray([0], np.int32), np.asarray([3], np.int32),
            np.zeros((1, 600), np.int32), src + 600,
            np.ones((1, 600), bool), src)


def test_apply_fuse_capacity_cut_is_the_same_and_consistent(capsys):
    cap = (4, 1200, 1200)
    port = native.NativeMapGraph(MapCapacity(*cap))
    jx = jax_native.NativeMapGraph(JCap(*cap))
    args = _overflow_graph(port)
    _overflow_graph(jx)
    r, rj = port.apply_fuse(*args), jx.apply_fuse(*args)
    assert _same(r, rj)
    assert "capacity hit: 200" in capsys.readouterr().err
    (a_kf, _, _), (m_src, m_dst), killed = r
    assert len(a_kf) == 0 and m_src.tolist() == list(range(400))
    assert m_dst.tolist() == list(range(600, 1000))
    assert killed.tolist() == list(range(400))
    assert np.array_equal(port.kf_row, jx.kf_row)
    # the cut tail is untouched; the merged half is whole
    for i in range(600):
        x, y = i, 600 + i
        if i < 400:
            assert not port.pt_alive[x] and port.n_obs(x) == 0
            assert sorted(k for k, _ in port.obs_pairs(y)) == [0, 1, 2, 3]
            assert port.kf_row[0, i] == y and port.kf_row[1, i] == -1
        else:
            assert port.pt_alive[x] and port.n_obs(x) == 3
            assert port.n_obs(y) == 3 and port.kf_row[1, i] == x
    # the mirror agrees with the arena's observations
    for p in port.points_with_obs():
        for kf, ft in port.obs_pairs(p):
            assert port.kf_row[kf, ft] == p


@pytest.mark.parametrize("value", [None, "0", "1"])
def test_tracker_keeps_the_python_graph(monkeypatch, value):
    """The arena is held from the tracker (ROADMAP.md, A1): whatever
    `TPU_SLAM_NATIVE_GRAPH` says (the JAX package's switch), the port's
    tracker builds the Python graph."""
    if value is None:
        monkeypatch.delenv("TPU_SLAM_NATIVE_GRAPH", raising=False)
    else:
        monkeypatch.setenv("TPU_SLAM_NATIVE_GRAPH", value)
    cfg = tracking.TrackerConfig(
        width=64, height=48, fx=50.0, fy=50.0, cx=32.0, cy=24.0, bf=4.0,
        n_features=64, n_levels=2, enable_local_ba=False,
        map_capacity=MapCapacity(4, 256, 64))
    tr = tracking.Tracker(cfg, device="cpu")
    assert type(tr.graph) is MapGraph
    tr.reset_map()
    assert type(tr.graph) is MapGraph


@pytest.mark.parametrize("compiler", ["missing", "false"])
def test_a_failing_build_raises(monkeypatch, tmp_path, compiler):
    """No fallback to the Python graph: a missing compiler, or one that
    fails, raises RuntimeError naming it."""
    cxx = (str(tmp_path / "no-such-g++") if compiler == "missing"
           else "false")
    monkeypatch.setattr(native, "CXX", cxx)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match=re.escape(cxx)):
        native.NativeMapGraph(MapCapacity(4, 64, 16))
    assert not any(f.endswith(".so") for f in
                   os.listdir(tmp_path / "build"))


# -- the tracker on the arena ---------------------------------------------

N_FRAMES = 20
KW = dict(width=320, height=240, fx=260.0, fy=260.0, cx=160.0, cy=120.0,
          bf=0.08 * 260.0, n_features=500, n_levels=4, enable_local_ba=True,
          pipelined=False)
CAP = (16, 4096, 500)


def _clip():
    planes = box_room(half_x=1.5, half_y=1.2, z_far=2.5, z_near=-2.5)
    scene = SyntheticScene(width=320, height=240, fx=260.0, fy=260.0,
                           planes=planes)
    gt = orbit_trajectory(N_FRAMES, radius=0.35, yaw_amp=0.25)
    rng = np.random.default_rng(0)
    frames = []
    for i in range(N_FRAMES):
        img, depth = scene.render(gt[i])
        depth = depth * (1 + rng.normal(0, 0.01, depth.shape))
        frames.append((np.clip(img, 0, 255).astype(np.uint8),
                       depth.astype(np.float16).astype(np.float32)))
    return frames


def _port_tracker(graph=MapGraph):
    """A port tracker on the clip's configuration whose host graph is
    built by `graph` (in place of the `MapGraph` the tracker constructs)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tracking, "MapGraph", graph)
        tr = tracking.Tracker(tracking.TrackerConfig(
            map_capacity=MapCapacity(*CAP), **KW), device="cpu")
    return tr


@pytest.fixture(scope="module")
def arena_run():
    """The clip tracked on the arena with every graph call recorded
    (`tr.graph._log`)."""
    log = []
    tr = _port_tracker(lambda cap: GraphTrace(native.NativeMapGraph(cap),
                                              log))
    for img, depth in _clip():
        tr.track_rgbd(img, depth)
    tr.flush()
    assert isinstance(tr.graph._g, native.NativeMapGraph)
    return tr


def test_tracker_trace_replays_on_the_jax_arena(arena_run):
    log = list(arena_run.graph._log)
    names = Counter(n for n, _, _, _ in log)
    # the mapping job's calls are in the trace
    for name in ("apply_fuse", "refresh_export", "update_connections",
                 "covis_neighbors", "redundant_obs", "young_points",
                 "add_observation", "pt_alive.set"):
        assert names[name] > 0, name
    jx = jax_native.NativeMapGraph(JCap(*CAP))
    for i, (name, args, kw, r) in enumerate(log):
        rj = _invoke(jx, name, copy_value(args), kw)
        assert _same(r, rj), (i, name, args, r, rj)
    assert np.array_equal(arena_run.graph.kf_row, jx.kf_row)
    assert arena_run.graph.pt_quarantine == jx.pt_quarantine
    assert not any(t.get("lost") for t in arena_run.track_info)
    assert arena_run.local_mapper.n_ba >= 2


def test_map_files_load_across_graphs(arena_run, tmp_path):
    """A map saved from either graph loads into either with the same
    observations, covisibility weights, parents, loop edges and live
    points (rows may come in another order). The load rebuilds the weights
    from the saved rows, so both graphs hold the same weights after it;
    the running graph may hold older ones a later keyframe has not
    rebuilt."""
    src = arena_run
    kfs = src.graph.alive_kfs()
    src.graph.loop_edges.setdefault(int(kfs[0]), set()).add(int(kfs[-1]))
    src.graph.loop_edges.setdefault(int(kfs[-1]), set()).add(int(kfs[0]))
    want = _graph_content(src.graph)
    assert want[2] and want[1]
    save_map(src, str(tmp_path / "arena.npz"))
    graphs = {"0": MapGraph, "1": native.NativeMapGraph}
    loaded = {}
    for graph in ("0", "1"):
        tr = load_map(_port_tracker(graphs[graph]),
                      str(tmp_path / "arena.npz"))
        assert type(tr.graph) is graphs[graph]
        got = _graph_content(tr.graph)
        assert got[:1] + got[2:] == want[:1] + want[2:], graph
        save_map(tr, str(tmp_path / f"from{graph}.npz"))
        loaded[graph] = got
    assert loaded["0"] == loaded["1"]
    # the Python graph's file into the arena, the arena's into the Python
    # graph
    for graph, src_file in (("1", "from0"), ("0", "from1")):
        tr = load_map(_port_tracker(graphs[graph]),
                      str(tmp_path / f"{src_file}.npz"))
        assert type(tr.graph) is graphs[graph]
        assert _graph_content(tr.graph) == loaded["0"], (graph, src_file)
        if graph == "0":
            # culling re-parents through the children the load recorded
            for k in np.nonzero(np.asarray(want[3]) >= 0)[0]:
                assert int(k) in tr.graph.children[want[3][k]]
