"""CLI drivers: replay a dataset sequence through the SLAM system.

Port of `orb_slam2_refactored_tpu/drivers.py`, the reference's example mains
(`Examples/Monocular/{mono_tum,mono_kitti,mono_euroc}.cc`,
`Examples/Stereo/{stereo_kitti,stereo_euroc}.cc`, `Examples/RGB-D/rgbd_tum.cc`):
load a sequence, replay it (optionally paced to its timestamps, as the
reference sleeps, `mono_tum.cc:92-100`), print the median and mean tracking
time (`mono_tum.cc:106-115`) and save the trajectories.

Usage (on the card by default; `--device cpu` runs the plain versions):
  python -m orb_slam2_refactored_tpu_torch.drivers rgbd_tum --settings TUM1.yaml \\
      --sequence /data/rgbd_dataset_freiburg1_desk --out traj.txt
  python -m orb_slam2_refactored_tpu_torch.drivers stereo_kitti --settings K00.yaml \\
      --sequence /data/kitti/00 --out traj.txt --kitti-out traj_kitti.txt
  python -m orb_slam2_refactored_tpu_torch.drivers synthetic_rgbd --frames 120

`stereo_euroc` rectifies the raw pairs when the settings carry LEFT./RIGHT.
rectification blocks (`io/datasets.py::EurocRectifier`), as the reference
(`stereo_euroc.cc:61-107`) and the JAX package's driver do.
"""

from __future__ import annotations

import argparse
import glob
import os
import struct
import sys
import time
import zlib

import numpy as np

from .io import datasets, png
from .slam.system import MONOCULAR, RGBD, STEREO, SlamSystem


def _report(times, system: SlamSystem, out: str, kf_out: str, kitti_out: str):
    times = sorted(times)
    if times:
        print(f"median tracking time: {times[len(times) // 2]:.4f}")
        print(f"mean tracking time: {sum(times) / len(times):.4f}")
    lc = system.tracker.loop_closer
    if lc is not None:
        print(f"loops closed: {lc.loops_closed}")
    if out:
        system.save_trajectory_tum(out)
        print(f"trajectory saved to {out}")
    if kf_out:
        system.save_keyframe_trajectory_tum(kf_out)
    if kitti_out:
        system.save_trajectory_kitti(kitti_out)


def _run(system: SlamSystem, stream, track_fn, args):
    times = []
    n = 0
    prev_ts = None
    for item in stream:
        t0 = time.time()
        track_fn(system, item)
        dt = time.time() - t0
        times.append(dt)
        n += 1
        if args.max_frames and n >= args.max_frames:
            break
        if args.realtime and prev_ts is not None:
            # the reference's pacing: sleep to the dataset's timestamps
            gap = item[0] - prev_ts
            if dt < gap:
                time.sleep(gap - dt)
        prev_ts = item[0]
    _report(times, system, args.out, args.kf_out, args.kitti_out)
    return system


def _parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("mode", choices=[
        "mono_tum", "mono_kitti", "mono_euroc",
        "stereo_kitti", "stereo_euroc", "rgbd_tum", "synthetic_rgbd",
        "live_rgbd",
    ])
    p.add_argument("--watch", help="live_rgbd: directory to watch for "
                   "incoming rgb/<ts>.png + depth/<ts>.png pairs")
    p.add_argument("--idle-timeout", type=float, default=5.0,
                   help="live_rgbd: exit after this many seconds without "
                   "a new frame")
    p.add_argument("--settings", help="reference-format YAML settings file")
    p.add_argument("--sequence", help="dataset sequence directory")
    p.add_argument("--timestamps", help="EuRoC timestamp file")
    p.add_argument("--assoc", help="TUM association file")
    p.add_argument("--out", default="trajectory_tum.txt")
    p.add_argument("--kf-out", default="")
    p.add_argument("--kitti-out", default="")
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--frames", type=int, default=120, help="synthetic frames")
    p.add_argument("--realtime", action="store_true",
                   help="pace replay to dataset timestamps (reference default)")
    p.add_argument("--no-loop-closing", action="store_true")
    p.add_argument("--save-map", default="",
                   help="persist the full SLAM state after the run")
    p.add_argument("--load-map", default="",
                   help="restore a saved map before tracking (relocalizes "
                   "against it)")
    p.add_argument("--device", default=None,
                   help="torch device to track on (default: cuda:0)")
    return p


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.mode == "synthetic_rgbd":
        return _run_synthetic(args)
    if args.mode == "live_rgbd":
        return _run_live_rgbd(args)

    sensor = {
        "mono_tum": MONOCULAR, "mono_kitti": MONOCULAR, "mono_euroc": MONOCULAR,
        "stereo_kitti": STEREO, "stereo_euroc": STEREO, "rgbd_tum": RGBD,
    }[args.mode]
    system = SlamSystem.create(
        args.settings, sensor, enable_loop_closing=not args.no_loop_closing,
        device=args.device)
    if args.load_map:
        system.load_map(args.load_map)

    if args.mode == "rgbd_tum":
        stream = datasets.tum_rgbd_sequence(args.sequence, args.assoc)
        _run(system, stream, lambda s, it: s.track_rgbd(it[1], it[2], it[0]),
             args)
    elif args.mode == "mono_tum":
        stream = datasets.tum_mono_sequence(args.sequence)
        _run(system, stream, lambda s, it: s.track_monocular(it[1], it[0]),
             args)
    elif args.mode == "mono_kitti":
        stream = datasets.kitti_mono_sequence(args.sequence)
        _run(system, stream, lambda s, it: s.track_monocular(it[1], it[0]),
             args)
    elif args.mode == "stereo_kitti":
        stream = datasets.kitti_stereo_sequence(args.sequence)
        _run(system, stream,
             lambda s, it: s.track_stereo(it[1], it[2], it[0]), args)
    elif args.mode == "stereo_euroc":
        rect = None
        if system.settings.rectification is not None:
            rect = datasets.EurocRectifier(system.settings.rectification)
        stream = datasets.euroc_stereo_sequence(args.sequence,
                                                args.timestamps, rect)
        _run(system, stream,
             lambda s, it: s.track_stereo(it[1], it[2], it[0]), args)
    elif args.mode == "mono_euroc":
        stream = datasets.euroc_mono_sequence(args.sequence, args.timestamps)
        _run(system, stream, lambda s, it: s.track_monocular(it[1], it[0]),
             args)
    if args.save_map:
        system.save_map(args.save_map)
        print(f"map saved to {args.save_map}")
    return 0


def _read_or_none(path, gray: bool):
    """A frame file that may still be being written: None until it reads."""
    try:
        return png.read_gray(path) if gray else png.read_png(path)
    except (OSError, ValueError, struct.error, zlib.error):
        return None


def _run_live_rgbd(args):
    """Live-source RGB-D tracking: track synchronized frame pairs as they
    arrive in a watched directory (the reference's ROS node,
    `Examples/ROS/ORB_SLAM2/src/ros_rgbd.cc`, with the filesystem as its
    transport): a producer drops `rgb/<ts>.png` and `depth/<ts>.png`, and
    each pair is tracked once both exist. Exits after --idle-timeout
    seconds without a new frame, then reports and saves as every mode
    does."""
    system = SlamSystem.create(
        args.settings, RGBD, enable_loop_closing=not args.no_loop_closing,
        device=args.device)
    if args.load_map:
        system.load_map(args.load_map)
    watch = args.watch or args.sequence
    assert watch, "live_rgbd requires --watch DIR"

    def scan():
        rgbs = {os.path.basename(f)[:-4]: f
                for f in glob.glob(os.path.join(watch, "rgb", "*.png"))}
        deps = {os.path.basename(f)[:-4]: f
                for f in glob.glob(os.path.join(watch, "depth", "*.png"))}
        try:
            return sorted(set(rgbs) & set(deps), key=float), rgbs, deps
        except ValueError:  # a non-numeric stem: lexical order
            return sorted(set(rgbs) & set(deps)), rgbs, deps

    times = []
    seen = set()
    last_new = time.time()
    n = 0
    while time.time() - last_new < args.idle_timeout:
        stems, rgbs, deps = scan()
        progressed = False
        for ts in stems:
            if ts in seen:
                continue
            img = _read_or_none(rgbs[ts], gray=True)
            dep = _read_or_none(deps[ts], gray=False)
            if img is None or dep is None:
                continue  # partly written; read again at the next scan
            seen.add(ts)
            t0 = time.time()
            system.track_rgbd(img.astype(np.float32), dep.astype(np.float32),
                              float(ts))
            times.append(time.time() - t0)
            n += 1
            last_new = time.time()
            progressed = True
            if args.max_frames and n >= args.max_frames:
                last_new = -1e18  # leave the loop
                break
        if not progressed:
            time.sleep(0.02)
    _report(times, system, args.out, args.kf_out, args.kitti_out)
    if args.save_map:
        system.save_map(args.save_map)
        print(f"map saved to {args.save_map}")
    return 0


def _run_synthetic(args):
    from .io.evaluation import ate_rmse
    from .io.synthetic import SyntheticScene, box_room, orbit_trajectory
    from .slam.map_state import MapCapacity
    from .slam.tracking import Tracker, TrackerConfig

    planes = box_room(half_x=1.5, half_y=1.2, z_far=2.5, z_near=-2.5)
    scene = SyntheticScene(width=640, height=480, fx=520.0, fy=520.0,
                           planes=planes)
    n = args.frames
    gt = orbit_trajectory(n, radius=0.35, yaw_amp=0.3)
    cfg = TrackerConfig(
        width=640, height=480, fx=520.0, fy=520.0, cx=320.0, cy=240.0,
        bf=0.08 * 520.0, n_features=1000, n_levels=8,
        map_capacity=MapCapacity(max_keyframes=128, max_points=16384,
                                 max_features=1000),
    )
    tracker = Tracker(cfg, args.device)
    times = []
    for i in range(n):
        img, depth = scene.render(gt[i])
        t0 = time.time()
        tracker.track_rgbd(img, depth, timestamp=i / 30.0)
        times.append(time.time() - t0)
    est = np.stack(tracker.trajectory)
    rmse, _ = ate_rmse(est, gt, align="se3")
    times_s = sorted(times)
    print(f"median tracking time: {times_s[len(times_s) // 2]:.4f}")
    print(f"ATE RMSE: {rmse:.4f} m over {n} frames, "
          f"{len(tracker.graph.alive_kfs())} keyframes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
