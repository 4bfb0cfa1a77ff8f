"""The C++ map-graph arena: its build, its ctypes bindings and
`NativeMapGraph`.

Port of `orb_slam2_refactored_tpu/native.py`. `csrc/map_graph.cpp` is a
byte-for-byte copy of the JAX package's `native/map_graph.cpp`: observation
lists, covisibility and the spanning tree in one single-threaded arena the
host drives between device programs, with the fuse-decision loop
(`mg_apply_fuse`) and the refresh export (`mg_refresh_export`) as one call
each. It is host code in both packages; no device touches it.

The library is built by `g++` (`FLAGS`: no `-march=native`, so the binary
runs on whichever host builds it) the first time a graph is constructed,
never at import, into `build/torch_native/`, cached by a hash of the source
and the flags. Concurrent builds (test workers) each compile to a name of
their own and `os.replace` it into place. The JAX package's committed
`native/libmapgraph.so` is never loaded.

`NativeMapGraph` presents the port's `slam/map_state.py::MapGraph`
interface (`covis_w`, `set_parent`, a `kf_tcp` dict, the facades
`pt_alive`, `pt_first_kf`, `parent` and `loop_edges`), so every caller
takes either graph. The tracker still builds the Python graph: the arena
is held from it until cell F's loop gate holds on it on the H100
(ROADMAP.md, A1). Tests and `chip_smoke.py --arena` put a tracker on it
by replacing the `MapGraph` that `slam/tracking.py` constructs.

Difference from the JAX package, on purpose: where the JAX tracker falls
back to its Python graph quietly when the library cannot be built or
loaded, the port raises `RuntimeError` naming the compiler and its error
output. A graph asked to be the arena is the arena or fails.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from typing import Dict, List, Set

import numpy as np

from .slam.map_state import MapGraph

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(PKG_DIR, "csrc", "map_graph.cpp")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "torch_native")
CXX = "g++"
FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]

_lib = None
_lock = threading.Lock()

_c_i32, _c_i64, _c_vp = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p
_p_i32 = ctypes.POINTER(ctypes.c_int32)
_p_u8 = ctypes.POINTER(ctypes.c_uint8)
# the JAX package's signatures (`native.py:37-80`)
SIGNATURES = {
    "mg_create": ([_c_i32, _c_i32], _c_vp),
    "mg_destroy": ([_c_vp], None),
    "mg_set_kf_alive": ([_c_vp, _c_i32, _c_i32], None),
    "mg_kf_alive": ([_c_vp, _c_i32], _c_i32),
    "mg_set_pt_alive": ([_c_vp, _c_i32, _c_i32], None),
    "mg_pt_alive": ([_c_vp, _c_i32], _c_i32),
    "mg_fill_pt_alive": ([_c_vp, _p_u8, _c_i32], None),
    "mg_set_pt_first_kf": ([_c_vp, _c_i32, _c_i64], None),
    "mg_pt_first_kf": ([_c_vp, _c_i32], _c_i64),
    "mg_set_origin": ([_c_vp, _c_i32], None),
    "mg_origin": ([_c_vp], _c_i32),
    "mg_add_observation": ([_c_vp, _c_i32, _c_i32, _c_i32], None),
    "mg_erase_observation": ([_c_vp, _c_i32, _c_i32], None),
    "mg_n_obs": ([_c_vp, _c_i32], _c_i32),
    "mg_get_obs": ([_c_vp, _c_i32, _p_i32, _p_i32, _c_i32], _c_i32),
    "mg_obs_feat_in_kf": ([_c_vp, _c_i32, _c_i32], _c_i32),
    "mg_refresh_export": ([_c_vp, _p_i32, _c_i32, _c_i32, _c_i32,
                           _p_i32, _p_i32, _p_i32, _p_i32, _c_i32], _c_i32),
    "mg_apply_fuse": ([_c_vp, _p_i32, _p_i32, _c_i32, _p_i32, _p_i32, _p_u8,
                       _p_i32, _c_i32, _p_i32, _p_i32, _p_i32, _p_i32,
                       _p_i32, _p_i32, _p_i32, _p_i32, _p_i32, _p_i32,
                       _p_i32, _p_i32, _p_i32, _c_i32], _c_i32),
    "mg_covis_weight": ([_c_vp, _c_i32, _c_i32], _c_i32),
    "mg_covis_neighbors": ([_c_vp, _c_i32, _c_i32, _c_i32, _p_i32, _c_i32],
                           _c_i32),
    "mg_update_connections": ([_c_vp, _c_i32, _p_i32, _c_i32, _c_i32], None),
    "mg_parent": ([_c_vp, _c_i32], _c_i32),
    "mg_set_parent": ([_c_vp, _c_i32, _c_i32], None),
    "mg_add_loop_edge": ([_c_vp, _c_i32, _c_i32], None),
    "mg_loop_edges": ([_c_vp, _c_i32, _p_i32, _c_i32], _c_i32),
    "mg_kill_point": ([_c_vp, _c_i32, _p_i32, _p_i32, _c_i32], _c_i32),
    "mg_kill_keyframe": ([_c_vp, _c_i32], None),
    "mg_reset_kf": ([_c_vp, _c_i32], None),
    "mg_redundant_obs": ([_c_vp, _c_i32, _p_i32, _p_i32, _c_i32, _p_i32],
                         _c_i32),
}


def library_path() -> str:
    """Where the build of this source with these flags lives."""
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libmapgraph-{h.hexdigest()[:16]}.so")


def build_library() -> str:
    """Compile `csrc/map_graph.cpp` unless its build is cached; returns the
    library's path. Raises RuntimeError when the compiler is missing or
    fails."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [CXX] + FLAGS + ["-o", tmp, SOURCE]
    try:
        p = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"map-graph build: cannot run {CXX!r}: {e}") from e
    if p.returncode != 0:
        raise RuntimeError(f"map-graph build: {' '.join(cmd)} exited "
                           f"{p.returncode}:\n{p.stderr}")
    os.replace(tmp, path)
    return path


def load_library() -> ctypes.CDLL:
    """The arena's ctypes handle, built at the first call."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            for name, (argtypes, restype) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
    return _lib


def compiler_version() -> str:
    """The first line of the compiler's `--version`."""
    p = subprocess.run([CXX, "--version"], capture_output=True, text=True,
                       check=True)
    return p.stdout.splitlines()[0]


def _as_i32_ptr(arr: np.ndarray):
    return arr.ctypes.data_as(_p_i32)


class NativeMapGraph:
    """The port's `MapGraph` interface backed by the C++ arena.

    Observation lists, covisibility, the spanning tree, loop edges and the
    point flags live in the arena; keyframe flags, sequence numbers and the
    `kf_row` / `kf_levels` mirrors stay in numpy on the host. The point
    flags and first keyframes are also mirrored in numpy (written through
    on every set, and after the kills `mg_kill_point` and `mg_apply_fuse`
    return), so the callers' per-point reads cost no C call.

    Orders differ from the Python graph where the arena's hash containers
    decide them: `obs_pairs`, `points_with_obs`, `loop_edges.get` and the
    refresh export follow `std::unordered_map` / `unordered_set` iteration,
    and `covis_neighbors` breaks weight ties lowest keyframe first (the
    Python graph keeps insertion order). Both are the JAX package's arena's
    orders exactly."""

    def __init__(self, cap):
        lib = load_library()
        self._lib = lib
        self.cap = cap
        self._h = lib.mg_create(cap.max_keyframes, cap.max_points)
        # num_kfs = keyframes ever created; next_kf_slot = fresh-slot cursor
        self.num_kfs = 0
        self.next_kf_slot = 0
        self.next_point = 0
        self.kf_seq = np.full(cap.max_keyframes, -1, np.int64)
        self.kf_quarantine: List = []
        self.kf_alive = np.zeros(cap.max_keyframes, bool)
        self.kf_frame_id = np.full(cap.max_keyframes, -1, np.int64)
        self.kf_timestamp = np.zeros(cap.max_keyframes, np.float64)
        self.kf_watermark = np.zeros(cap.max_keyframes, np.int64)
        self.pt_visible = np.zeros(cap.max_points, np.int32)
        self.pt_found = np.zeros(cap.max_points, np.int32)
        self.pt_first_kf = _FirstKf(self)
        self.pt_alive = _PtAlive(self)
        self._scratch_kf = np.zeros(4096, np.int32)
        self._scratch_feat = np.zeros(4096, np.int32)
        # host mirrors of the device's kf_mp rows and keypoint levels
        self.kf_row = np.full(
            (cap.max_keyframes, cap.max_features), -1, np.int32)
        self.kf_levels = np.zeros(
            (cap.max_keyframes, cap.max_features), np.int32)
        self.big_change_counter = 0
        self.pt_quarantine: List = []
        self.recycled_log: List[int] = []
        self.young_pts: List = []
        self._obs_points: Set[int] = set()
        self.loop_edges = _LoopEdges(self)
        self.parent = _Parent(self)
        # culled keyframe -> (parent slot, Tcp f32[7]) recorded at cull time
        self.kf_tcp: Dict[int, tuple] = {}

    def __del__(self):
        h = getattr(self, "_h", None)
        if h is not None:
            self._lib.mg_destroy(h)
            self._h = None

    # -- slots ---------------------------------------------------------

    @property
    def origin_kf(self) -> int:
        return int(self._lib.mg_origin(self._h))

    @origin_kf.setter
    def origin_kf(self, kf: int):
        self._lib.mg_set_origin(self._h, int(kf))

    # the slot and lifecycle bookkeeping lives in the host mirrors, as in
    # the Python graph: the same code
    can_alloc_kf = MapGraph.can_alloc_kf
    _pop_recyclable_kf = MapGraph._pop_recyclable_kf
    alloc_kf_slot = MapGraph.alloc_kf_slot
    alloc_point_slots = MapGraph.alloc_point_slots
    return_point_slots = MapGraph.return_point_slots
    note_new_point = MapGraph.note_new_point
    young_points = MapGraph.young_points
    set_levels = MapGraph.set_levels
    alive_kfs = MapGraph.alive_kfs

    def _reset_kf_slot(self, slot: int):
        """Scrub a recycled slot: the arena drops its tree links and loop
        edges (`mg_reset_kf`), the mirrors their identity fields."""
        self._lib.mg_reset_kf(self._h, int(slot))
        self.kf_frame_id[slot] = -1
        self.kf_timestamp[slot] = 0.0
        self.kf_row[slot] = -1

    def set_parent(self, kf: int, p: int):
        """`parent[kf] = p`; the arena records kf among p's children."""
        self.parent[kf] = p

    def set_kf_alive(self, kf: int, alive: bool):
        self.kf_alive[kf] = alive
        self._lib.mg_set_kf_alive(self._h, int(kf), int(alive))

    # -- observations ---------------------------------------------------

    def add_observation(self, pt: int, kf: int, feat: int,
                        is_stereo: bool = False):
        self._lib.mg_add_observation(self._h, int(pt), int(kf), int(feat))
        self._obs_points.add(int(pt))
        self.kf_row[kf, feat] = pt

    def erase_observation(self, pt: int, kf: int):
        feat = int(self._lib.mg_obs_feat_in_kf(self._h, int(pt), int(kf)))
        self._lib.mg_erase_observation(self._h, int(pt), int(kf))
        if feat >= 0 and self.kf_row[kf, feat] == pt:
            self.kf_row[kf, feat] = -1

    def n_obs(self, pt: int) -> int:
        return int(self._lib.mg_n_obs(self._h, int(pt)))

    def obs_pairs(self, pt: int) -> List:
        n = self._lib.mg_get_obs(
            self._h, int(pt), _as_i32_ptr(self._scratch_kf),
            _as_i32_ptr(self._scratch_feat), len(self._scratch_kf))
        return list(zip(self._scratch_kf[:n].tolist(),
                        self._scratch_feat[:n].tolist()))

    def obs_feat_in_kf(self, pt: int, kf: int) -> int:
        return int(self._lib.mg_obs_feat_in_kf(self._h, int(pt), int(kf)))

    def apply_fuse(self, srcs, dsts, idx_all, dst_pt_all, keep_all,
                   src_mp_all):
        """The fuse decisions applied in the arena (`mg_apply_fuse`), one
        call for the Python per-feature loop of `LocalMapper._drain_fuse`.
        Returns (adds (kf, ft, pt), merges (src, dst resolved along merge
        chains), killed points) and updates the kf_row mirror.

        Each item checks the room left in the outputs before it changes
        anything; on overflow the tail is skipped whole (fusion is
        best-effort; later keyframes retry), so what is returned is always
        consistent with the arena."""
        n_pairs = len(srcs)
        n_feat = idx_all.shape[1]
        cap = max(n_pairs * n_feat * 2, 1024)
        i32 = np.int32
        a_kf, a_ft, a_pt = (np.zeros(cap, i32) for _ in range(3))
        m_src, m_dst = np.zeros(cap, i32), np.zeros(cap, i32)
        u_kf, u_ft, u_val = (np.zeros(cap, i32) for _ in range(3))
        kl = np.zeros(cap, i32)
        counts = np.zeros(4, i32)
        rc = self._lib.mg_apply_fuse(
            self._h,
            _as_i32_ptr(np.ascontiguousarray(srcs, i32)),
            _as_i32_ptr(np.ascontiguousarray(dsts, i32)),
            n_pairs,
            _as_i32_ptr(np.ascontiguousarray(idx_all, i32)),
            _as_i32_ptr(np.ascontiguousarray(dst_pt_all, i32)),
            np.ascontiguousarray(keep_all, np.uint8).ctypes.data_as(_p_u8),
            _as_i32_ptr(np.ascontiguousarray(src_mp_all, i32)),
            n_feat,
            _as_i32_ptr(a_kf), _as_i32_ptr(a_ft), _as_i32_ptr(a_pt),
            _as_i32_ptr(counts[0:1]),
            _as_i32_ptr(m_src), _as_i32_ptr(m_dst),
            _as_i32_ptr(counts[1:2]),
            _as_i32_ptr(u_kf), _as_i32_ptr(u_ft), _as_i32_ptr(u_val),
            _as_i32_ptr(counts[2:3]),
            _as_i32_ptr(kl), _as_i32_ptr(counts[3:4]),
            cap,
        )
        if rc > 0:
            print(f"[map-graph] fuse output capacity hit: {int(rc)} kept "
                  f"features deferred to later keyframes", file=sys.stderr)
        n_add, n_merge, n_upd, n_kill = (int(c) for c in counts)
        # the mirrors (the arena already updated its observation maps)
        if n_upd:
            self.kf_row[u_kf[:n_upd], u_ft[:n_upd]] = u_val[:n_upd]
        for p in a_pt[:n_add]:
            self._obs_points.add(int(p))
        self.pt_alive.flags[kl[:n_kill]] = False
        for p in kl[:n_kill]:
            self._obs_points.discard(int(p))
            self.pt_quarantine.append((int(p), self.num_kfs))
        return ((a_kf[:n_add], a_ft[:n_add], a_pt[:n_add]),
                (m_src[:n_merge], m_dst[:n_merge]), kl[:n_kill])

    def refresh_export(self, mp_row: np.ndarray, min_obs: int, M: int,
                       B: int):
        """The observation tables of the live points with >= min_obs
        observations in a keyframe's row, in one call: (pts i32[B], obs_kf
        i32[B, M], obs_ft i32[B, M], nob i32[B], count)."""
        row = np.ascontiguousarray(mp_row, np.int32)
        pts = np.zeros(B, np.int32)
        okf = np.zeros((B, M), np.int32)
        oft = np.zeros((B, M), np.int32)
        nob = np.zeros(B, np.int32)
        n = self._lib.mg_refresh_export(
            self._h, _as_i32_ptr(row), len(row), int(min_obs), int(M),
            _as_i32_ptr(pts), _as_i32_ptr(okf), _as_i32_ptr(oft),
            _as_i32_ptr(nob), B)
        return pts, okf, oft, nob, int(n)

    def points_with_obs(self):
        dead = [p for p in self._obs_points if self.n_obs(p) == 0]
        for p in dead:
            self._obs_points.discard(p)
        return list(self._obs_points)

    # -- covisibility ----------------------------------------------------

    def covis_w(self, a: int, b: int) -> int:
        return int(self._lib.mg_covis_weight(self._h, int(a), int(b)))

    def covis_neighbors(self, kf: int, min_weight: int = 0, top_k: int = 0):
        n = self._lib.mg_covis_neighbors(
            self._h, int(kf), int(min_weight), int(top_k),
            _as_i32_ptr(self._scratch_kf), len(self._scratch_kf))
        return self._scratch_kf[:n].tolist()

    def update_connections(self, kf: int, kf_mp_row: np.ndarray,
                           obs_for_new=True):
        row = np.ascontiguousarray(kf_mp_row, np.int32)
        self._lib.mg_update_connections(
            self._h, int(kf), _as_i32_ptr(row), len(row), int(obs_for_new))

    # -- lifecycle -------------------------------------------------------

    def kill_point(self, pt: int):
        if not self.pt_alive[pt]:
            return []
        n = self._lib.mg_kill_point(
            self._h, int(pt), _as_i32_ptr(self._scratch_kf),
            _as_i32_ptr(self._scratch_feat), len(self._scratch_kf))
        self._obs_points.discard(int(pt))
        self.pt_alive.flags[pt] = False
        pairs = list(zip(self._scratch_kf[:n].tolist(),
                         self._scratch_feat[:n].tolist()))
        for kf, feat in pairs:
            if self.kf_row[kf, feat] == pt:
                self.kf_row[kf, feat] = -1
        self.pt_quarantine.append((int(pt), self.num_kfs))
        return pairs

    def kill_keyframe(self, kf: int):
        if kf == self.origin_kf:
            return
        self._lib.mg_kill_keyframe(self._h, int(kf))
        self.kf_alive[kf] = False
        self.kf_row[kf] = -1
        self.kf_quarantine.append((int(kf), self.num_kfs))

    def redundant_obs(self, kf: int, mp_row: np.ndarray,
                      levels_all: np.ndarray):
        row = np.ascontiguousarray(mp_row, np.int32)
        lv = np.ascontiguousarray(levels_all, np.int32)
        total = ctypes.c_int32(0)
        red = self._lib.mg_redundant_obs(
            self._h, int(kf), _as_i32_ptr(row), _as_i32_ptr(lv), lv.shape[1],
            ctypes.byref(total))
        return int(red), int(total.value)

    def arena_pt_alive(self) -> np.ndarray:
        """The arena's own point flags (`mg_fill_pt_alive`), which the
        `pt_alive` mirror must equal."""
        buf = np.zeros(self.cap.max_points, np.uint8)
        self._lib.mg_fill_pt_alive(self._h, buf.ctypes.data_as(_p_u8),
                                   len(buf))
        return buf.astype(bool)

    def alive_points(self) -> np.ndarray:
        return np.nonzero(self.pt_alive.flags)[0]


class _PtAlive:
    """The arena's point flags with numpy's item idioms:
    `pt_alive[pt]`, `pt_alive[pt] = x`, `pt_alive.sum()`. Reads come from
    the numpy mirror `flags`; writes go to both."""

    def __init__(self, g: NativeMapGraph):
        self._g = g
        self.flags = np.zeros(g.cap.max_points, bool)

    def __getitem__(self, pt):
        return bool(self.flags[pt])

    def __setitem__(self, pt, v):
        self._g._lib.mg_set_pt_alive(self._g._h, int(pt), int(bool(v)))
        self.flags[pt] = bool(v)

    def sum(self):
        return int(self.flags.sum())


class _FirstKf:
    """The arena's first-keyframe sequence numbers, read from a numpy
    mirror (the arena changes them only when told)."""

    def __init__(self, g: NativeMapGraph):
        self._g = g
        self._seq = np.full(g.cap.max_points, -1, np.int64)

    def __getitem__(self, pt):
        return int(self._seq[pt])

    def __setitem__(self, pt, v):
        self._g._lib.mg_set_pt_first_kf(self._g._h, int(pt), int(v))
        self._seq[pt] = int(v)


class _LoopEdges:
    """The arena's loop edges as the dict of sets the callers read
    (`get`) and extend (`setdefault(kf, set()).add(other)`, which adds the
    edge both ways, as the callers' two calls do)."""

    def __init__(self, g: NativeMapGraph):
        self._g = g

    def get(self, kf, default=None):
        n = self._g._lib.mg_loop_edges(
            self._g._h, int(kf), _as_i32_ptr(self._g._scratch_kf),
            len(self._g._scratch_kf))
        s = set(self._g._scratch_kf[:n].tolist())
        return s if (s or default is None) else default

    def setdefault(self, kf, default):
        return _LoopEdgeAdder(self._g, kf)


class _LoopEdgeAdder:
    def __init__(self, g, kf):
        self._g, self._kf = g, kf

    def add(self, other):
        self._g._lib.mg_add_loop_edge(self._g._h, int(self._kf), int(other))


class _Parent:
    """Parent slots; a write also records the child in the arena
    (`mg_set_parent`)."""

    def __init__(self, g: NativeMapGraph):
        self._g = g

    def __getitem__(self, kf):
        return int(self._g._lib.mg_parent(self._g._h, int(kf)))

    def __setitem__(self, kf, p):
        self._g._lib.mg_set_parent(self._g._h, int(kf), int(p))
