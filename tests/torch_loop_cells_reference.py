"""Cells E, F and H (and A) of `chip_smoke.py` through the JAX package on
the CPU: the reference numbers beside the port's cells. Not a test; run
by hand:

    JAX_PLATFORMS=cpu python3 tests/torch_loop_cells_reference.py \\
        [--graph python|native] [--port] [--depth N] [A] [E] [F] [H]
    JAX_PLATFORMS=cpu python3 tests/torch_loop_cells_reference.py \\
        [--graph python|native] --lockstep [--jax-pyramid] \\
        [--trace-graph] [--frames N] E

Each cell's 170 circuit frames are rendered by `chip_smoke.circuit_frames`,
so they are the card run's frames, and its configuration is
`chip_smoke.circuit_config` as the JAX package's `TrackerConfig`.

Without `--lockstep`, the JAX package's `Tracker.track_rgbd` (with
`--port`, the port's, on the CPU) runs each cell with loop closing off and
on, and prints one JSON line a run: the corrected trajectory's ATE
(`corrected_frame_poses`), the loops closed, the final state, lost frames,
alive keyframes and points, the last loop's record and the wall time.
Cell H (the mono circuit, `chip_smoke.mono_circuit_frames` and
`mono_circuit_config`) runs through `track_mono` with loop closing on
only, and its ATE is sim3-aligned.

With `--lockstep`, the port (on the CPU) and the JAX package run the cell
frame by frame with loop closing off, and print one JSON line a frame: the
two tracked positions' largest difference (`dt`, metres), each package's
inliers, matches and keyframe flag, alive keyframes and points, and each
package's position error against the ground truth. A last line names the
first frame where the discrete results (inliers, matches, keyframes,
points) part. `--jax-pyramid` builds the port's pyramid levels with the JAX
package's `build_pyramid`, which removes the source of difference at the
first frame (ROADMAP.md, C2); the next is frame 1's projection (C15).
`--trace-graph` records every graph call each tracker makes (name,
arguments, result) and prints the first that differs between the
packages; `--frames N` stops after N frames.

Cell A (the bench's 120 VGA orbit frames, `chip_smoke.bench_config`,
loop closing off) is there for `--depth`'s sake: phase 3m's A-pipe.
`--depth N` runs the cells pipelined (`pipelined=True`,
`pipeline_depth=N`, phase 3m's F-pipe at 6) with loop closing on only;
the JAX package's mapper reads are resolved at once (its `_fetch`
returns `_Resolved`), as the port's are on the CPU, so both packages
pump every stage when it comes due.

`--port-pyramid` feeds the JAX package the port's plain pyramid instead
(a host callback inside its compiled extraction).

`--graph` chooses both packages' host graph before any tracker is built:
`python` (the default) gives each its Python map graph, `native` each its
C++ arena (the JAX package's default graph; the port's `native.py`, built
from its own copy of the source). The JAX package reads
`TPU_SLAM_NATIVE_GRAPH` ("0" or "1"), which the script sets; the port's
tracker has no switch (the arena is held from it, ROADMAP.md A1), so the
script replaces the `MapGraph` it constructs. The script checks that every
tracker got the graph asked for, since the JAX package falls back to its
Python graph quietly. On the C++ graph tied covisibility weights are
ordered lowest keyframe first, so a run there parts from the Python
graph's run of the same cell.
"""

import argparse
import dataclasses
import hashlib
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


GRAPHS = {"python": "0", "native": "1"}


def check_graph(tracker, graph):
    """The tracker got the graph `--graph` asked for."""
    native = type(tracker.graph).__name__ == "NativeMapGraph"
    assert native == (graph == "native"), (type(tracker.graph), graph)


def port_config(cell, loop, depth=0):
    import chip_smoke

    if cell == "A":
        return chip_smoke.pipelined(chip_smoke.bench_config(True), depth)
    return chip_smoke.pipelined(
        chip_smoke.mono_circuit_config() if cell == "H"
        else chip_smoke.circuit_config(cell, loop), depth)


def jax_config(cell, loop, depth=0):
    """The port configuration of `port_config` as the JAX package's
    `TrackerConfig`."""
    from orb_slam2_refactored_tpu.slam.map_state import MapCapacity
    from orb_slam2_refactored_tpu.slam.tracking import TrackerConfig

    cfg = port_config(cell, loop, depth)
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    cap = cfg.map_capacity
    fields["map_capacity"] = MapCapacity(cap.max_keyframes, cap.max_points,
                                         cap.max_features)
    return TrackerConfig(**fields)


def ate_runs(cell, graph, port=False, depth=0):
    import chip_smoke
    from orb_slam2_refactored_tpu_torch.io.evaluation import ate_rmse
    if port:
        from orb_slam2_refactored_tpu_torch.slam.system import (
            corrected_frame_poses)
        from orb_slam2_refactored_tpu_torch.slam.tracking import Tracker
    else:
        from orb_slam2_refactored_tpu.slam.system import (
            corrected_frame_poses)
        from orb_slam2_refactored_tpu.slam.tracking import Tracker, _Resolved

    mono = cell == "H"
    if cell == "A":
        imgs, depths, gt = chip_smoke.bench_frames(chip_smoke.N_FRAMES)
        frames = list(zip(imgs, depths))
    else:
        frames, gt = (chip_smoke.mono_circuit_frames() if mono
                      else chip_smoke.circuit_frames(cell))
    for loop in ((False,) if cell == "A" else (True,) if mono or depth
                 else (False, True)):
        t0 = time.time()
        tracker = (Tracker(port_config(cell, loop, depth), device="cpu")
                   if port else Tracker(jax_config(cell, loop, depth)))
        if depth and not port and tracker.local_mapper is not None:
            tracker.local_mapper._fetch = lambda a: _Resolved(np.asarray(a))
        check_graph(tracker, graph)
        for i, frame in enumerate(frames):
            if mono:
                tracker.track_mono(frame, timestamp=i / 30.0)
            else:
                tracker.track_rgbd(frame[0], frame[1].astype(np.float32),
                                   timestamp=i / 30.0)
        tracker.flush()
        ate, _ = ate_rmse(corrected_frame_poses(tracker), gt,
                          align="sim3" if mono else "se3")
        lc = tracker.loop_closer
        print(json.dumps({
            "package": "port" if port else "jax", "graph": graph,
            "cell": cell, "loop_closing": loop, "ate_m": float(ate),
            "loops_closed": lc.loops_closed if lc else 0,
            "state": int(tracker.state), "pipeline_depth": depth,
            "lost_frames": sum(1 for t in tracker.track_info
                               if t.get("lost")),
            "first_lost": next((i for i, t in enumerate(tracker.track_info)
                                if t.get("lost")), None),
            "keyframes_alive": int(len(tracker.graph.alive_kfs())),
            "map_points_alive": int(tracker.graph.pt_alive.sum()),
            "last_loop_info": str(tracker.last_loop_info),
            "wall_s": time.time() - t0}), flush=True)


def use_jax_pyramid():
    """Build the port's pyramid levels with the JAX package's compiled
    `build_pyramid` (as `tests/test_torch_tracking.py` does)."""
    import jax
    import jax.numpy as jnp
    import torch

    from orb_slam2_refactored_tpu.ops import image as jax_image
    from orb_slam2_refactored_tpu_torch.ops import image as port_image

    fn = jax.jit(jax_image.build_pyramid, static_argnums=(1, 2))

    def build_pyramid(img, n_levels, scale_factor):
        return [torch.from_numpy(np.array(lvl)) for lvl in
                fn(jnp.asarray(img.numpy()), n_levels, scale_factor)]

    port_image.build_pyramid = build_pyramid


def use_port_pyramid():
    """Build the JAX package's pyramid levels with the port's plain
    `build_pyramid` on the CPU (the reverse of `use_jax_pyramid`), through
    a host callback inside the JAX extractor's compiled program."""
    import jax
    import jax.numpy as jnp
    import torch

    from orb_slam2_refactored_tpu.ops import image as jax_image
    from orb_slam2_refactored_tpu_torch.ops import image as port_image

    def build_pyramid(img, n_levels, scale_factor):
        shapes = jax_image.pyramid_shapes(*img.shape, n_levels, scale_factor)

        def host(x):
            return tuple(np.asarray(lvl, np.float32) for lvl in
                         port_image.build_pyramid_plain(
                             torch.from_numpy(np.array(x, np.float32)),
                             n_levels, scale_factor))

        return list(jax.pure_callback(
            host, tuple(jax.ShapeDtypeStruct(s, jnp.float32)
                        for s in shapes), img))

    jax_image.build_pyramid = build_pyramid


def _norm(v):
    """A comparable form of a graph call's argument or result: arrays by
    their values (as int64 or float64 bytes), sets unordered, sequences in
    order."""
    if isinstance(v, np.ndarray):
        kind = np.float64 if v.dtype.kind == "f" else np.int64
        return ("array", v.shape, hashlib.sha1(
            np.ascontiguousarray(v, kind).tobytes()).hexdigest())
    if isinstance(v, (set, frozenset)):
        return frozenset(_norm(x) for x in v)
    if isinstance(v, (list, tuple)):
        return tuple(_norm(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _norm(x)) for k, x in v.items()))
    if isinstance(v, (np.integer, np.bool_, np.floating)):
        return v.item()
    return v


def lockstep(cell, graph, n_frames=None, trace=False):
    import torch

    import chip_smoke
    from torch_graph_trace import GraphTrace
    from orb_slam2_refactored_tpu.slam.tracking import Tracker as JaxTracker
    from orb_slam2_refactored_tpu_torch.slam.tracking import Tracker

    frames, gt = chip_smoke.circuit_frames(cell)
    port = Tracker(chip_smoke.circuit_config(cell, False), device="cpu")
    ref = JaxTracker(jax_config(cell, False))
    check_graph(port, graph)
    check_graph(ref, graph)
    logs, done, parted = ([], []), 0, None
    if trace:
        port.graph = GraphTrace(port.graph, logs[0])
        ref.graph = GraphTrace(ref.graph, logs[1])
    t0 = time.time()
    first = None
    for i, (img, depth) in enumerate(frames[:n_frames]):
        depth = depth.astype(np.float32)
        a = np.asarray(port.track_rgbd(img, depth, timestamp=i / 30.0))
        b = np.asarray(ref.track_rgbd(img, depth, timestamp=i / 30.0))
        if trace and parted is None:
            # compare the calls both packages have made, then drop them
            lp, lj = logs
            for k in range(max(len(lp), len(lj))):
                x = _norm(lp[k]) if k < len(lp) else None
                y = _norm(lj[k]) if k < len(lj) else None
                if x != y:
                    parted = {"frame": i, "call": done + k,
                              "port": str(x)[:400], "jax": str(y)[:400],
                              "before": [c[0] for c in
                                         lp[max(0, k - 12):k]]}
                    print(json.dumps({"first_graph_call_parting": parted}),
                          flush=True)
                    break
            n = min(len(lp), len(lj))
            done += n
            del lp[:n], lj[:n]
        elif trace:
            lp.clear(), lj.clear()
        info = [{k: v for k, v in t.track_info[-1].items() if k != "lost"}
                if t.track_info else {} for t in (port, ref)]
        g = [getattr(t.graph, "_g", t.graph) for t in (port, ref)]
        kfs = [len(g[0].alive_kfs()), len(g[1].alive_kfs())]
        pts = [int(g[0].pt_alive.sum()), int(len(g[1].alive_points()))]
        err = [float(np.abs(x[4:] - gt[i][4:]).max()) for x in (a, b)]
        print(json.dumps({"frame": i,
                          "dt": float(np.abs(a[4:] - b[4:]).max()),
                          "port": info[0], "jax": info[1], "kfs": kfs,
                          "pts": pts, "gt_err": err}), flush=True)
        if first is None and (info[0] != info[1] or kfs[0] != kfs[1]
                              or pts[0] != pts[1]):
            first = i
    print(json.dumps({"cell": cell, "graph": graph,
                      "first_discrete_parting": first,
                      "first_graph_call_parting": parted,
                      "graph_calls_compared": done,
                      "torch_threads": torch.get_num_threads(),
                      "wall_s": time.time() - t0}))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("cells", nargs="*", default=["E", "F"])
    ap.add_argument("--lockstep", action="store_true")
    ap.add_argument("--jax-pyramid", action="store_true")
    ap.add_argument("--port", action="store_true")
    ap.add_argument("--port-pyramid", action="store_true",
                    help="feed the JAX package the port's plain pyramid")
    ap.add_argument("--graph", choices=sorted(GRAPHS), default="python")
    ap.add_argument("--depth", type=int, default=0,
                    help="run pipelined with N frames in flight, loop "
                    "closing on only")
    ap.add_argument("--frames", type=int, default=None,
                    help="with --lockstep: only the first N frames")
    ap.add_argument("--trace-graph", action="store_true",
                    help="with --lockstep: record both trackers' graph "
                    "calls and print the first that differs")
    args = ap.parse_args()
    os.environ["TPU_SLAM_NATIVE_GRAPH"] = GRAPHS[args.graph]
    if args.graph == "native":
        from orb_slam2_refactored_tpu_torch import native
        from orb_slam2_refactored_tpu_torch.slam import tracking

        tracking.MapGraph = native.NativeMapGraph
    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.jax_pyramid:
        use_jax_pyramid()
    if args.port_pyramid:
        use_port_pyramid()
    for cell in args.cells:
        if args.lockstep:
            lockstep(cell, args.graph, args.frames, args.trace_graph)
        else:
            ate_runs(cell, args.graph, port=args.port, depth=args.depth)


if __name__ == "__main__":
    main()
