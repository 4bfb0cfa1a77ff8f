"""State carried across from the JAX package (or any numpy source).

For SLAM the state that plays the part of weights is the map and the
tracker's per-frame carry. These helpers move them between numpy arrays
(`np.asarray` of each JAX leaf) and the port's tensors. Descriptors are
uint32 on the JAX side and int32 here: the bits are the same, reinterpreted
with `.view`.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .optim.ba import BAProblem
from .optim.pose_graph import PoseGraphProblem
from .slam.frame import FrameData
from .slam.map_state import MapArrays
from .slam.vocabulary import KeyFrameDatabase, Vocabulary

_DESC_FIELDS = ("kf_desc", "mp_desc", "desc", "words")


def _as_dict(obj) -> Dict[str, Any]:
    if isinstance(obj, dict):
        return obj
    return obj._asdict()


def _to_tensor(name: str, a, device):
    a = np.ascontiguousarray(a)
    if name in _DESC_FIELDS:
        a = a.view(np.int32)  # uint32 bits, reinterpreted
    elif a.dtype == np.int64:
        a = a.astype(np.int32)
    return torch.from_numpy(a.copy()).to(device)


def _to_numpy(name: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    if name in _DESC_FIELDS:
        a = np.ascontiguousarray(a).view(np.uint32)
    return a


def map_from_numpy(d, device) -> MapArrays:
    """MapArrays from a dict (or NamedTuple) of numpy arrays."""
    d = _as_dict(d)
    return MapArrays(**{k: _to_tensor(k, d[k], device)
                        for k in MapArrays._fields})


def map_to_numpy(m: MapArrays) -> Dict[str, np.ndarray]:
    return {k: _to_numpy(k, getattr(m, k)) for k in MapArrays._fields}


def frame_from_numpy(d, device) -> FrameData:
    d = _as_dict(d)
    return FrameData(**{k: _to_tensor(k, d[k], device)
                        for k in FrameData._fields})


def frame_to_numpy(f: FrameData) -> Dict[str, np.ndarray]:
    return {k: _to_numpy(k, getattr(f, k)) for k in FrameData._fields}


def vocabulary_from_numpy(d, device) -> Vocabulary:
    """Vocabulary from a dict (or NamedTuple) with `words` (u32[W,8]) and
    `idf` (f32[W])."""
    d = _as_dict(d)
    return Vocabulary(words=_to_tensor("words", d["words"], device),
                      idf=_to_tensor("idf", d["idf"], device))


def vocabulary_to_numpy(voc: Vocabulary) -> Dict[str, np.ndarray]:
    """{"words": u32[W,8], "idf": f32[W]}: the JAX package's dtypes."""
    return {k: _to_numpy(k, getattr(voc, k)) for k in Vocabulary._fields}


def database_from_numpy(voc: Vocabulary, kf_capacity: int, bow_ids,
                        bow_cnt, active, idf) -> KeyFrameDatabase:
    """A KeyFrameDatabase over `voc` holding the sparse rows (bow_ids
    i32[KF,T], bow_cnt f32[KF,T]), the active mask (bool[KF], kept on the
    host) and the live idf (f32[W]) of another one."""
    dev = voc.words.device
    db = KeyFrameDatabase(voc, kf_capacity)
    db.bow_ids = _to_tensor("bow_ids", bow_ids, dev)
    db.bow_cnt = _to_tensor("bow_cnt", bow_cnt, dev)
    db.active = np.asarray(active, bool).copy()
    db.idf = _to_tensor("idf", idf, dev)
    return db


def tracker_state_from_numpy(d, device) -> Dict[str, Any]:
    """The per-frame carry of `Tracker._step_impl`: keys `last_frame`,
    `last_mp`, `pose`, `velocity`, `ref_kf`, `mp_vis`, `mp_found`,
    `mp_seen`, `fidx` (ref_kf and fidx as Python ints)."""
    d = _as_dict(d)
    return {
        "last_frame": frame_from_numpy(d["last_frame"], device),
        "last_mp": _to_tensor("last_mp", d["last_mp"], device),
        "pose": _to_tensor("pose", np.asarray(d["pose"], np.float32), device),
        "velocity": _to_tensor("velocity",
                               np.asarray(d["velocity"], np.float32), device),
        "ref_kf": int(d["ref_kf"]),
        "mp_vis": _to_tensor("mp_vis", d["mp_vis"], device),
        "mp_found": _to_tensor("mp_found", d["mp_found"], device),
        "mp_seen": _to_tensor("mp_seen", d["mp_seen"], device),
        "fidx": int(d["fidx"]),
    }


def ba_problem_from_numpy(d, device) -> BAProblem:
    """BAProblem from a dict (or NamedTuple) of numpy arrays; `pt_frozen`
    may be absent or None."""
    d = _as_dict(d)
    return BAProblem(**{
        k: (None if d.get(k) is None else _to_tensor(k, d[k], device))
        for k in BAProblem._fields})


def mapper_inputs_from_numpy(d, device) -> Dict[str, Any]:
    """The index arguments of one `LocalMapper` device program, keyed as the
    JAX program names them (window arrays of `_ba_impl`: win_idx, win_free,
    win_valid, pt_lut, pts_local; observer lists of `_refresh_points_impl`:
    pts, obs_kf, obs_feat, n_obs), as tensors (int64 as int32)."""
    return {k: _to_tensor(k, v, device) for k, v in _as_dict(d).items()}


def pose_graph_problem_from_numpy(d, device) -> PoseGraphProblem:
    """PoseGraphProblem from a dict (or NamedTuple) of numpy arrays."""
    d = _as_dict(d)
    return PoseGraphProblem(**{k: _to_tensor(k, d[k], device)
                               for k in PoseGraphProblem._fields})


_LOOP_COUNTERS = ("last_loop_kf", "last_loop_seq", "loops_closed")


def loop_state(closer) -> Dict[str, Any]:
    """The detection state of a `LoopCloser` of either package (its
    consistency groups as (set, count) pairs, the last loop's keyframe and
    creation sequence, the loops closed), as plain Python values."""
    out = {k: int(getattr(closer, k)) for k in _LOOP_COUNTERS}
    out["consistent_groups"] = [({int(k) for k in g}, int(n))
                                for g, n in closer.consistent_groups]
    return out


def set_loop_state(closer, state: Dict[str, Any]):
    """Give `closer` the detection state `state` (see `loop_state`)."""
    for k in _LOOP_COUNTERS:
        setattr(closer, k, int(state[k]))
    closer.consistent_groups = [({int(k) for k in g}, int(n))
                                for g, n in state["consistent_groups"]]
    return closer
