"""Phase 3p's ingest runs of `chip_smoke.py` on the CPU, through the JAX
package or the port: the reference numbers beside the card's. Not a test;
run by hand:

    JAX_PLATFORMS=cpu python3 tests/torch_ingest_reference.py \\
        [--port] [--stereo] [--image raw|dct] [--depth log8|f16] \\
        [--mode uploaded|pair|chain4] [--jax-pyramid] [--jax-unpack] \\
        [--threads N]

RGB-D: the frames are `chip_smoke.bench_frames(120)` (cell A's), the
configuration `chip_smoke.ingest_config` (the bench's RGB-D tracker: VGA,
1000 features, 8 levels, log8 depth at subsample 8, pipelined at depth 6)
with `--image` as its `image_encoding`; `--depth f16` sends f16 depth at
full resolution instead, as cells A-I do. `--stereo`: cell C's pairs
(`chip_smoke.bench_stereo_frames`) through the bench's stereo tracker
(pipelined at depth 3). Both packages upload through `prefetch_rgbd` (or
`prefetch_stereo`) and step per frame, in pairs or in chains of 4, as
`bench.py`'s ingest modes 1, 2 and 4 do. The JAX package's mapper reads
are resolved at once (its `_fetch` returns `_Resolved`), as the port's are
on the CPU. With `--port`, `--jax-pyramid` builds the port's pyramid
levels with the JAX package's `build_pyramid` (ROADMAP.md, C2) and
`--jax-unpack` feeds the port tracker the arrays of the JAX package's
`_unpack_impl` on the same packed bytes (log8 decoded by XLA's `exp`):
each takes one source of difference between the packages away. Prints one
JSON line: ATE (SE3-aligned), frames lost, keyframes made, wall seconds.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

MODES = {"uploaded": 1, "pair": 2, "chain4": 4}


def jax_config(cfg):
    """The JAX package's `TrackerConfig` with the fields of the port's."""
    from orb_slam2_refactored_tpu.slam.map_state import MapCapacity
    from orb_slam2_refactored_tpu.slam.tracking import TrackerConfig

    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    c = cfg.map_capacity
    fields["map_capacity"] = MapCapacity(c.max_keyframes, c.max_points,
                                         c.max_features)
    return TrackerConfig(**fields)


def jax_unpack(cfg):
    """A port tracker's `_unpack` through the JAX package's `_unpack_impl`,
    called on a stub that holds its `TrackerConfig`."""
    import types

    import jax.numpy as jnp
    import torch

    from orb_slam2_refactored_tpu.slam.tracking import Tracker as JTracker

    stub = types.SimpleNamespace(cfg=jax_config(cfg))
    for name in ("_packed_depth_hw", "_packed_img_nbytes"):
        setattr(stub, name, types.MethodType(getattr(JTracker, name), stub))

    def unpack(buf):
        img, dep = JTracker._unpack_impl(stub, jnp.asarray(buf.numpy()))
        return (torch.from_numpy(np.array(img)),
                torch.from_numpy(np.array(dep)))

    return unpack


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", action="store_true")
    ap.add_argument("--stereo", action="store_true")
    ap.add_argument("--image", choices=("raw", "dct"), default="raw")
    ap.add_argument("--depth", choices=("log8", "f16"), default="log8")
    ap.add_argument("--mode", choices=tuple(MODES), default="uploaded")
    ap.add_argument("--jax-pyramid", action="store_true")
    ap.add_argument("--jax-unpack", action="store_true")
    ap.add_argument("--threads", type=int, default=2)
    args = ap.parse_args()
    import torch

    torch.set_num_threads(args.threads)
    import chip_smoke

    imgs, depths, gt = chip_smoke.bench_frames(120)
    if args.stereo:
        second = chip_smoke.bench_stereo_frames(gt)[1]
        cfg = chip_smoke.pipelined(chip_smoke.bench_config(True),
                                   chip_smoke.PIPE_DEPTHS["C"])
    else:
        second = [d.astype(np.float32) for d in depths]
        cfg = chip_smoke.ingest_config(image_encoding=args.image)
        if args.depth == "f16":
            cfg = dataclasses.replace(cfg, depth_encoding="f16",
                                      depth_subsample=1)
    if args.port:
        from orb_slam2_refactored_tpu_torch.io.evaluation import ate_rmse
        from orb_slam2_refactored_tpu_torch.slam.tracking import Tracker

        if args.jax_pyramid:
            from torch_loop_cells_reference import use_jax_pyramid

            use_jax_pyramid()
        tracker = Tracker(cfg, device="cpu")
        if args.jax_unpack:
            tracker._unpack = jax_unpack(cfg)
    else:
        from orb_slam2_refactored_tpu.io.evaluation import ate_rmse
        from orb_slam2_refactored_tpu.slam.tracking import Tracker, _Resolved

        tracker = Tracker(jax_config(cfg))
        tracker.local_mapper._fetch = lambda a: _Resolved(np.asarray(a))
    if args.stereo:
        futs = tracker.prefetch_stereo(list(imgs), list(second))
        one, pair, chain = (tracker.track_stereo_uploaded,
                            tracker.track_stereo_pair_uploaded,
                            tracker.track_stereo_chain_uploaded)
    else:
        futs = tracker.prefetch_rgbd(list(imgs), second)
        one, pair, chain = (tracker.track_rgbd_uploaded,
                            tracker.track_rgbd_pair_uploaded,
                            tracker.track_rgbd_chain_uploaded)
    t0 = time.perf_counter()
    k = MODES[args.mode]
    for i in range(0, len(imgs), k):
        bufs = [f.result() for f in futs[i:i + k]]
        ts = [(i + j) / 30.0 for j in range(len(bufs))]
        if len(bufs) == 1:
            one(bufs[0], timestamp=ts[0])
        elif len(bufs) == 2:
            pair(bufs[0], bufs[1], *ts)
        else:
            chain(bufs, ts)
    tracker.flush()
    est = np.stack(tracker.trajectory)
    print(json.dumps({
        "package": "port" if args.port else "jax",
        "input": "stereo" if args.stereo else f"{args.image}+{args.depth}",
        "mode": args.mode, "jax_pyramid": args.jax_pyramid,
        "jax_unpack": args.jax_unpack,
        "ate_m": float(ate_rmse(est, gt, align="se3")[0]),
        "lost_frames": sum(1 for t in tracker.track_info if t.get("lost")),
        "keyframes_created": 1 + sum(1 for t in tracker.track_info
                                     if t.get("kf")),
        "wall_s": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
