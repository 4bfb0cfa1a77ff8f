"""Cells E, F and H of `chip_smoke.py` through the JAX package on the CPU:
the reference numbers beside the port's loop cells. Not a test; run by
hand:

    JAX_PLATFORMS=cpu TPU_SLAM_NATIVE_GRAPH=0 \\
        python3 tests/torch_loop_cells_reference.py [--port] [E] [F] [H]
    JAX_PLATFORMS=cpu TPU_SLAM_NATIVE_GRAPH=0 \\
        python3 tests/torch_loop_cells_reference.py --lockstep [--jax-pyramid] E

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
package's `build_pyramid`, which removes the one known source of
difference at the first frame (ROADMAP.md, C2).

`TPU_SLAM_NATIVE_GRAPH=0` selects the JAX package's Python map graph, the
one the port copies; with 1 (the JAX package's default where its C++ graph
builds) tied covisibility weights are ordered differently and the runs
part.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def port_config(cell, loop):
    import chip_smoke

    return (chip_smoke.mono_circuit_config() if cell == "H"
            else chip_smoke.circuit_config(cell, loop))


def jax_config(cell, loop):
    """The port configuration of `port_config` as the JAX package's
    `TrackerConfig`."""
    from orb_slam2_refactored_tpu.slam.map_state import MapCapacity
    from orb_slam2_refactored_tpu.slam.tracking import TrackerConfig

    cfg = port_config(cell, loop)
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    cap = cfg.map_capacity
    fields["map_capacity"] = MapCapacity(cap.max_keyframes, cap.max_points,
                                         cap.max_features)
    return TrackerConfig(**fields)


def ate_runs(cell, port=False):
    import chip_smoke
    from orb_slam2_refactored_tpu_torch.io.evaluation import ate_rmse
    if port:
        from orb_slam2_refactored_tpu_torch.slam.system import (
            corrected_frame_poses)
        from orb_slam2_refactored_tpu_torch.slam.tracking import Tracker
    else:
        from orb_slam2_refactored_tpu.slam.system import (
            corrected_frame_poses)
        from orb_slam2_refactored_tpu.slam.tracking import Tracker

    mono = cell == "H"
    frames, gt = (chip_smoke.mono_circuit_frames() if mono
                  else chip_smoke.circuit_frames(cell))
    for loop in (True,) if mono else (False, True):
        t0 = time.time()
        tracker = (Tracker(port_config(cell, loop), device="cpu") if port
                   else Tracker(jax_config(cell, loop)))
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
            "package": "port" if port else "jax",
            "cell": cell, "loop_closing": loop, "ate_m": float(ate),
            "loops_closed": lc.loops_closed if lc else 0,
            "state": int(tracker.state),
            "lost_frames": sum(1 for t in tracker.track_info
                               if t.get("lost")),
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


def lockstep(cell):
    import torch

    import chip_smoke
    from orb_slam2_refactored_tpu.slam.tracking import Tracker as JaxTracker
    from orb_slam2_refactored_tpu_torch.slam.tracking import Tracker

    frames, gt = chip_smoke.circuit_frames(cell)
    port = Tracker(chip_smoke.circuit_config(cell, False), device="cpu")
    ref = JaxTracker(jax_config(cell, False))
    first = None
    for i, (img, depth) in enumerate(frames):
        depth = depth.astype(np.float32)
        a = np.asarray(port.track_rgbd(img, depth, timestamp=i / 30.0))
        b = np.asarray(ref.track_rgbd(img, depth, timestamp=i / 30.0))
        info = [{k: v for k, v in t.track_info[-1].items() if k != "lost"}
                if t.track_info else {} for t in (port, ref)]
        kfs = [len(port.graph.alive_kfs()), len(ref.graph.alive_kfs())]
        pts = [int(port.graph.pt_alive.sum()),
               int(len(ref.graph.alive_points()))]
        err = [float(np.abs(x[4:] - gt[i][4:]).max()) for x in (a, b)]
        print(json.dumps({"frame": i,
                          "dt": float(np.abs(a[4:] - b[4:]).max()),
                          "port": info[0], "jax": info[1], "kfs": kfs,
                          "pts": pts, "gt_err": err}), flush=True)
        if first is None and (info[0] != info[1] or kfs[0] != kfs[1]
                              or pts[0] != pts[1]):
            first = i
    print(json.dumps({"cell": cell, "first_discrete_parting": first,
                      "torch_threads": torch.get_num_threads()}))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("cells", nargs="*", default=["E", "F"])
    ap.add_argument("--lockstep", action="store_true")
    ap.add_argument("--jax-pyramid", action="store_true")
    ap.add_argument("--port", action="store_true")
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.jax_pyramid:
        use_jax_pyramid()
    for cell in args.cells:
        if args.lockstep:
            lockstep(cell)
        else:
            ate_runs(cell, port=args.port)


if __name__ == "__main__":
    main()
