"""Drive the PyTorch port of the RGB-D, stereo and monocular tracker, with
loop closing, and its system facade and CLI drivers, on one CUDA card.

    python3 chip_smoke.py [--profile] [--parent DIR]
    python3 chip_smoke.py --c13
    python3 chip_smoke.py --arena
    python3 chip_smoke.py --c13 --arena

Phases (any failure raises and the script exits non-zero):
 1. print the card, its power limit and the toolchain; build every CUDA
    kernel from `orb_slam2_refactored_tpu_torch/csrc` (one nvcc per source,
    all started together) and print each one's ptxas resource usage;
 2. hold extraction's kernels against their plain PyTorch versions on
    the card, as extraction calls them: K8 (the pyramid, one launch for
    levels 1-7, its tables built when the extractor is constructed) within
    1e-4 gray on the first frame and on every frame of cell A's 120, with
    each level's bit-equal share printed; K2 (FAST, NMS and the rank
    rounds of every level in one call, and each level alone), K9 (the
    spread top-k of every level in one launch) bit for bit, and K3, on
    the first frame's 8 levels and 1000 keypoints; time each with CUDA
    events, with the library calls that compute K8's and K9's functions
    (the plain version's 14 GEMMs with the weights on the card, bit-equal
    to K8; one stable `torch.sort` over the padded keys, the plain
    version's selection); drive the step's
    reference-keyframe fallback branch (local BA off);
 3. the main paths, each with every launch counter set to 0 just before
    and read just after, and no frame of any of them building K8's, K9's
    or K7's tables (a tracker builds them when it is constructed):
    a. local BA off (the path of the first slice): the first 60 frames of
       the bench's VGA box-room orbit (1000 features, 8 levels, 32768 map
       points) through `Tracker.track_rgbd` on cuda:0;
    b. local BA on (the bench's own setting): all 120 frames, with
       triangulation, fusion, culling and the dense-Schur window BA after
       every keyframe;
    c. stereo (the bench's stereo segment, synchronous, local BA on): the
       bench's 120 rectified VGA pairs (baseline 8 cm) through
       `Tracker.track_stereo`, with the stereo association a frame: the
       gate, K1, and one B9 launch for everything after K1 (the matched u,
       both medians, the per-level SAD refinement and the depth).
    d. kidnap (RGB-D, local BA on, a keyframe at least every 8 frames): a
       tracker of its own maps cell (b)'s frames 0-79, goes LOST through 12
       all-zero frames, and must relocalize within 20 frames of a resume at
       views 20-59 (post-recovery ATE <= 8 cm); the vocabulary is trained
       at the 4th keyframe and every keyframe is indexed;
    e. loop closing (cells E and F, each with loop closing off and on, the
       covisibility window of 10 keyframes and a keyframe at least every 8
       frames): E, the organic-loop test's QVGA panning circuit
       (`tests/test_organic_loop.py`, 170 frames, 600 features, 4 levels,
       16384 points); F, the bench's VGA panning circuit (`bench.py:555-615`,
       170 frames, the bench's configuration: 1000 features, 8 levels,
       32768 points, local BA on). Each must end tracking, close at least
       one loop, and beat its loop-off run's ATE on the corrected
       trajectory, below 6 cm (the organic-loop test's gates); the
       global BA's kernels (K5 in its `w_obs` mode, K6) launch exactly when
       a loop closed.
    g. mono orbit (cell G, the bench's mono probe, `bench.py:653-702`):
       cell (b)'s 120 VGA views through `Tracker.track_mono` twice, a
       warm-up lap that initializes (the H/F initializer, two keyframes,
       a 2-keyframe BA) and a measured lap; bf = 0, `kf_ref_ratio=0.9`,
       local BA on. Gates: OK at the end, >= 2 keyframes, sim3 ATE of the
       measured lap under 0.35 m; every kernel of the path launched, one
       K2 and one K3 call a frame;
    h. mono circuit with loop closing (cell H, `tests/test_mono_loop.py`'s
       scenario): 240 QVGA frames, 900 features, 4 levels, 1024 words.
       Gates (JAX's): OK at the end, a loop closed (an implicit one with
       >= 25 projected matches), sim3 ATE of the corrected trajectory under
       0.45 m; the global BA's kernels launched;
    i. the facade through the CLI (cell I): cell (b)'s 120 VGA frames
       written in the TUM layout through the port's `io/png.py` (8-bit
       gray, depth x 5000 in 16 bits, rgb.txt, depth.txt, groundtruth.txt)
       into a temporary directory, a settings YAML with the bench's camera
       and `ORBextractor.pattern: learned`, then
       `drivers.main(["rgbd_tum", ...])` in this process on cuda:0 (the
       settings reader, the TUM reader, `SlamSystem`, the three savers; the
       tracker takes `TrackerConfig`'s default map capacity, as JAX's CLI
       does). Gates: rc 0, the TUM file's 120 lines on the sequence's
       timestamps, the saved file's ATE against groundtruth.txt <= 3 cm, no
       frame lost, the KITTI file's 120 lines of 12 numbers, a keyframe
       line a live keyframe, every kernel of the path launched, K7 once a
       frame and K3 never, window BA at every keyframe after the second;
    j. the `stereo_kitti` and `mono_tum` CLIs on the JAX driver tests' own
       40-frame QVGA exports and gates (ATE < 5 cm, a line a frame; sim3
       ATE < 0.3 m, >= 30 lines); `stereo_euroc` on 40 raw EuRoC-layout
       pairs whose settings carry LEFT./RIGHT. blocks, so the driver
       rectifies every pair on the host (the JAX driver test's QVGA rig,
       600 features, 4 levels; and EuRoC's 752x480 with EuRoC.yaml's
       extractor settings, 1200 features, 8 levels): the JAX test's gates
       (ATE of the saved file, timestamps associated, < 5 cm over >= 35
       frames), the rectifier's host ms a pair printed;
    k. cameras past VGA, RGB-D on the bench's box-room orbit with its field
       of view (fx = 520 w / 640, 1000 features, 8 levels, local BA on):
       1920x1200, 30 frames (0 lost, ATE <= 3 cm) and 3840x2160, 10 frames
       (0 lost), each tracker's construction time (K8's GEMM probes and
       work split) and `SPLIT_MISSES` printed; K9's large kernel once a
       frame; then at 1920x1200, 2048x1088 and 3840x2160 K8 (bit for bit
       where `SPLIT_MISSES` is 0, else within 1e-4 gray), K2, K9 and K3
       against their plain versions on two frames, K8's and K9's
       CUDA-event times (50 calls back to back), and K9's large kernel
       alone on 3840x2160's levels 0-3 (its row in the kernel line);
    f. stereo save/load (run after phase 4's cell-(c) checks): cell (c)'s
       map through `save_map` and `load_map` into a fresh stereo tracker,
       which must relocalize within 3 pairs from view 40, within 2 cm of
       cell (c)'s pose there in the saved map (the pose it recorded
       relative to its reference keyframe, on that keyframe's saved pose).
    n. the sharded global BA (run after phase 5): (a) world size 1 over
       NCCL on cuda:0, every launch counter set to 0 just before and read
       just after: `parallel/distributed.py::dryrun`'s problem (K=256
       keyframes x 512 observations over 16,384 points, 2 LM x 8 CG) and
       cell F's first global BA through `sharded_ba_solve`, whose CG is K6
       split at its reductions (`ba_cg_ut`, `ba_cg_ap`, `ba_cg_update`:
       three launches a CG iteration, the collectives between them), each
       held to its plain solve in f64 at `check_gba`'s gate, the bf16
       control outside it; (b) the same two solves on two gloo ranks on
       cuda:0 (processes the script starts, `--sharded-rank`): costs,
       points and poses bit-equal on both ranks, within the gate of (a)'s
       result, every collective on CUDA tensors; (c) each entry against its
       plain version on the calls of one sharded CG on cell F's first LM
       iteration; (d) that CG's time beside K6's one launch on the same
       arguments (device times in a process of its own,
       `--sharded-times`), its launches and collectives a CG iteration and
       their host ms;
    o. the live viewer (run last): cell A's 120 frames again without a
       viewer (the control), then with `viz/viewer.py::LiveViewer` at 2 Hz
       on the tracker: cell A's ATE to the bit, `map_latest.png` decoding
       through `io/png.py`, `status.json` OK, at least one tick rendered
       while tracking, the render's host ms a tick and the step's median
       and p90 beside cell A's and the control's; then `viz/ar.py::ArOverlay` on the last frame: a plane found
       and the cube drawn (more than 50 red pixels); then the viewer's
       cost: the frames again with it rendering back to back, the same
       ATE bits, and the step's median and p90 of the frames that
       overlapped a render beside those apart from one.
    Each of (a)-(c) checks ATE against the 3 cm gate, that no frame was
    lost, that every kernel of its path launched and that K2 and K3
    launched once a frame (twice a stereo frame, with one B9 launch); every
    cell (a)-(k) and the save/load check that K8, K2 and K9 launched once
    an image (twice a stereo frame), and K9's large kernel never outside
    (k); (b)
    and (c) also that window BA ran at every keyframe after the second, and
    print the keyframe stages' times (`kf.loop`: the BoW index, on the
    training keyframe and on the others).
 4. every kernel against its plain version on the arguments the main path
    gave it, timed with CUDA events: K1, K2, K9, K3 and K4 on the calls of
    one more tracked frame (K1 and K4 also on the last fallback frame), K1's
    pair gate on one triangulation, K5 on one window BA at its real point
    bucket (and the whole window BA with K5 against the plain assembly);
    then, on cell (c), K1 and K4 on the calls of one more tracked stereo
    frame, its association bit for bit against the plain composition, its
    B9 launch and B9's SAD-only entry against their plain versions, and K5
    on one of its window BAs; on cell (d)'s recovering frame, its
    relocalization's K1 calls (quantization, matching, the polish's search)
    bit for bit and its K4 calls, the vocabulary trained again on the card
    and by the plain path bit-equal to the tracker's, and `compute_bow`
    equal to its plain version; on cell F's first global BA (its problem
    holds every live point of the 32768-point map), K5's `w_obs` mode
    against its plain version (its live rows through the point index) and
    its dense mode, the fused CG (K6) against `cg_solve_plain` in f64 on
    every LM iteration of the global BA (beside it the f32 CG's own spread
    under relabeled keyframes and tf32 and bf16 controls, which the
    yardstick must tell), the whole global BA with K5 and
    K6 against the plain global BA, and the loop's pose-graph solve on the
    card against the same solve on the CPU; on cell G, K1's window match of
    the bootstrap (both passes, under a dense [1000, 1000] pair gate) bit
    for bit, one more tracked mono frame's K1 and K4 calls (every row mono),
    K5 on the bootstrap's 2-keyframe window and on a later one; the mono
    fallback branch (`pnp_ransac`, then K4); the card's `initialize` and
    `pnp_ransac` against the CPU on the same samples (same success, model
    and winning hypotheses, pose within 1e-3); and C11: a global BA at
    P = 32768 with 30,000 live points, K5's index equal to the plain one
    and one LM iteration's K6 within the f64 yardstick; K7 (the learned
    pattern) on frame 0's keypoints and on the call of one more frame that
    cell I's system tracks: given the plain version's angles bit for bit,
    whole within the printed exceptions of `learned_tie_gate`, and a table
    with one pair swapped that must fail the same hold; B6 (the projection
    search's gates and compaction) bit for bit against its plain version
    on the projection searches the main paths made (one more tracked
    frame's, cell C's tracked stereo frame's, cell D's relocalization
    polish, every loop check of cells E and F), with R's projection mode
    on K1's output for B6's rows and the whole search (B6, K1, R) against
    the plain composition; R bit for bit on the tracked frame's, one
    triangulation's and one fusion's claims.
 5. torch.profiler windows, after every agreement check: K2's and K3's
    device time on frame 0 (and K7's), K8's, K9's, the plain pyramid's
    and top-k's and their library calls', each with its device
    operations, K1's and K4's on the recorded tracked frame's calls, K5's
    on the recorded window BA, B9's (and its wrapper's host time), the
    whole association's (no copy to or from the host in it) and
    the stereo K1 call's on the recorded stereo frame; each stage of cell
    (d)'s relocalization; K6's and K5 `w_obs`'s device time a call and
    their bounds, K6's barrier floor (its launch with empty phases), the
    whole global BA's and the pose graph's device time and operations,
    and the pose graph's bound (its operations counted from its shapes);
    the initializer's population and `pnp_ransac` (device time and
    operations, host time, bound), K1's mono window call and K4 on a mono
    frame, cell A's and cell G's tracked frames under the profiler (device
    operations a frame, busy share); B6's (both modes) and the tracked
    frame's R calls' device time, operations and wrappers' host us a call
    beside their plain versions', the whole projection search's and the
    whole motion-model search's beside their plain compositions', and
    each search's launches by `kernels.LAUNCHES` (three each);
    K4's time split into passes
    and LM iterations (the same calls without iterations) and one
    iteration on no observation;
    extraction in four variants on the same 20 frames: the plain rank
    rounds, the rank rounds in K2 (both with the plain pyramid and
    top-k), K8, K2, K9 and K3, and the learned pattern's K8, K2, K9 and
    K7 (both at most 10 device operations and no upload a frame, and no
    table built on a frame); with --profile, a
    frame's time broken down; with --parent DIR, K1, K4, K5, B9, K6, K8,
    K9 and K7 against the kernels of the checkout in DIR on the same
    recorded arguments (outputs, then device times and CUDA-event times in
    turns: parent, change, change, parent; K4's iteration on no
    observation; for B9 the parent's torch chain after K1 around its
    launch against the one launch, and for K6 the parent's whole CG step
    against the one launch; K8 on frame 0's and a tracked frame's images,
    K9 on their rank rounds as K2 left them, K7 on frame 0's keypoints
    and on cell I's tracked frame's call, its levels laid out as K8 writes
    them, outputs equal also given the plain version's angles; cell F's
    whole global BA, parent against change, in device time, operations and
    host time; the tracked frame's projection search, the parent's plain
    gates, K1 and plain resolution against B6, K1 and R; B6, R's two
    calls of the tracked frame and its motion-model search (the parent's
    gather and plain gates, K1 and R) against the parent's, each bound
    with its own C signature: outputs,
    device ms, CUDA-event ms and the wrappers' host us a call (1,000 calls,
    nothing waiting for the card), in turns; then cell A's
    120 frames through the parent's tracker and this one's in turns, the
    step's median and p90 and the ATE).
The line before the last is a JSON object with one entry per kernel; the
last line is `{"ok": true, "device": {...}}`.

With --arena the script measures the C++ map-graph arena (`native.py`),
which the tracker does not take yet (ROADMAP.md, A1): the port's copy of
`map_graph.cpp` built with g++ on this host, then cell A and cells E and F
(loop closing off and on) on the Python graph and on the arena, with the
ATEs, the tracked step and every `kf.*` stage side by side; cell A's gates
are held, the loop cells' recorded and not held. With --c13 --arena,
--c13's runs are made on the arena.

With --c13 the script runs only cells E and F, loop closing off and on,
under three orders of K8's partial sums (the card's GEMM's, one chain an
output, splits at 8-wide input blocks), and prints each run's ATE and
whether the cells' gates hold, holding none (`run_c13`).
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import ctypes
import inspect
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from functools import partial

import numpy as np
import torch

# H100 SXM peaks for the bounds below. Bytes: HBM3 at 3.35 TB/s (NVIDIA
# data sheet). Operations: instructions a second per class, 132 SMs at the
# 1.98 GHz boost clock times the lanes an SM serves a clock for compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput): f32 add/mul/fma/min/max 128 (the data sheet's 67 TFLOP/s
# counts an FMA as two), int32 add/logic/compare 64, popc 16. 128 a clock
# is also what an SM's four schedulers can issue in all.
PEAK_BYTES = 3.35e12
SM_CLOCKS = 132 * 1.98e9
PEAK_OPS = {"f32": 128 * SM_CLOCKS, "int32": 64 * SM_CLOCKS,
            "popc": 16 * SM_CLOCKS}
ISSUE_RATE = 128 * SM_CLOCKS
N_FRAMES = 120  # the bench's scored sequence
N_FRAMES_NO_BA = 60  # the local-BA-off path, cut to keep the run short
ATE_GATE_M = 0.03
WARMUP_FRAMES = 20
# cell D (`tests/test_kidnap_reloc.py`'s scenario on the bench's frames):
# mapped frames, blank frames, resume views, and the recovery bounds
KIDNAP_MAP = 80
KIDNAP_BLANK = 12
KIDNAP_RESUME = range(20, 60)
RELOC_MAX_FRAMES = 20
RELOC_ATE_M = 0.08
# the stereo save/load check resumes a loaded cell-C map at this view
RELOAD_VIEW = 40
# cells E and F (loop closing): the circuit's frames and the gates of the
# JAX package's organic-loop test (`tests/test_organic_loop.py:85-114`)
CIRCUIT_FRAMES = 170
LOOP_ATE_M = 0.06
# the global BA's kernels: they launch only where a loop closes
LOOP_KERNELS = ("ba_assemble_w_obs", "ba_schur_cg")
# the sharded global BA's CG (K6 split at its reductions): phase 3n only
SHARDED_KERNELS = ("ba_cg_ut", "ba_cg_ap", "ba_cg_update")
# K10, the packed frame's decode: it launches only where a frame carries
# log8 depth or a DCT image (phase 3p)
WIRE_KERNEL = "wire_unpack"
# the learned BRIEF pattern's kernel: it launches only on cell I (cells A-H
# run the fresh pattern on K3)
LEARNED_KERNEL = "orb_desc_learned"
# host seconds between a profiler window's edges and its launches
GUARD_S = 0.005
# extraction's kernels that launch once an image, whatever the pattern:
# K8 (the pyramid), K2 (FAST and the rank rounds), K9 (the spread top-k)
EXTRACTION_KERNELS = ("pyramid", "fast", "spread_topk")
# K9's kernel for levels past 8,192 candidates: no VGA or QVGA level has
# that many, so it launches at phase 3k's geometries only
LARGE_KERNEL = "spread_topk_large"


def sh(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def extraction_launches(launches, images, tag, large=False):
    """K8, K2 and K9 launched once for each of the cell's `images` (two a
    stereo frame); K9's large kernel as often where the geometry has a
    level past 8,192 candidates (`large`), else never."""
    got = {k: launches[k] for k in EXTRACTION_KERNELS + (LARGE_KERNEL,)}
    print(f"  {tag}: extraction launches {json.dumps(got)} for {images} "
          "images")
    assert set(got[k] for k in EXTRACTION_KERNELS) == {images}, (tag, got,
                                                                 images)
    assert got[LARGE_KERNEL] == images * large, (tag, got, images)


def card_line():
    return sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])


def cuda_time_ms(fn, reps):
    """Mean device time of one call, from CUDA events around `reps` calls
    after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bench_frames(n):
    """The bench's box-room orbit at VGA: uint8 images, f16-stored depth
    with 1 % multiplicative noise from numpy seed 0."""
    from orb_slam2_refactored_tpu_torch.io.synthetic import (
        SyntheticScene, box_room, orbit_trajectory)

    planes = box_room(half_x=1.8, half_y=1.4, z_far=3.0, z_near=-3.0)
    scene = SyntheticScene(width=640, height=480, fx=520.0, fy=520.0,
                           planes=planes)
    gt = orbit_trajectory(n, radius=0.4, yaw_amp=0.3)
    imgs = np.zeros((n, 480, 640), np.uint8)
    depths = np.zeros((n, 480, 640), np.float16)
    rng = np.random.default_rng(0)
    for i in range(n):
        img, depth = scene.render(gt[i])
        imgs[i] = np.clip(img, 0, 255).astype(np.uint8)
        depths[i] = (depth * (1 + rng.normal(0, 0.01, depth.shape))).astype(
            np.float16)
    return imgs, depths, gt


def bench_stereo_frames(gt):
    """The bench's stereo pairs (`bench.py:705-725`): the same box room and
    orbit, rendered with a right camera 8 cm along x, uint8."""
    from orb_slam2_refactored_tpu_torch.io.synthetic import (
        SyntheticScene, box_room)

    planes = box_room(half_x=1.8, half_y=1.4, z_far=3.0, z_near=-3.0)
    scene = SyntheticScene(width=640, height=480, fx=520.0, fy=520.0,
                           planes=planes, baseline=0.08)
    n = len(gt)
    left = np.zeros((n, 480, 640), np.uint8)
    right = np.zeros((n, 480, 640), np.uint8)
    for i in range(n):
        lft, rgt, _ = scene.render_stereo(gt[i])
        left[i] = np.clip(lft, 0, 255).astype(np.uint8)
        right[i] = np.clip(rgt, 0, 255).astype(np.uint8)
    return left, right


def bench_cam():
    from orb_slam2_refactored_tpu_torch.geometry.projection import (
        CameraIntrinsics)

    return CameraIntrinsics.create(520.0, 520.0, 320.0, 240.0, 0.08 * 520.0)


def bench_config(local_ba: bool):
    """`bench.py:98-107`'s RGB-D camera and tracker; `local_ba` is its
    `enable_local_ba` (the bench leaves it on), synchronous. Its stereo
    segment's (`bench.py:742-753`) is the same. It omits the bench's depth
    wire format (log8 at subsample 8, `bench.py:120-131`): cells A-I send
    f16 depth at full resolution, and phase 3p runs the bench's
    (`ingest_config`). The bench runs both pipelined (`pipelined`,
    PIPE_DEPTHS), as phases 3m and 3p do."""
    from orb_slam2_refactored_tpu_torch.slam.map_state import MapCapacity
    from orb_slam2_refactored_tpu_torch.slam.tracking import TrackerConfig

    return TrackerConfig(
        width=640, height=480, fx=520.0, fy=520.0, cx=320.0, cy=240.0,
        bf=0.08 * 520.0, n_features=1000, n_levels=8,
        map_capacity=MapCapacity(max_keyframes=128, max_points=32768,
                                 max_features=1000),
        enable_local_ba=local_ba, local_ba_iters=3,
        enable_loop_closing=False, pipelined=False)


def add_ops(total, **ops):
    for k, v in ops.items():
        total[k] = total.get(k, 0) + v


def bound_ms(nbytes, ops):
    """Least time for `nbytes` moved once and `ops` ({class: count}): each
    class at its own peak, and all of them through the issue limit."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = max(max(n / PEAK_OPS[c] for c, n in ops.items()),
                sum(ops.values()) / ISSUE_RATE) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def profiled_ms(fn, reps, ops_out=None, warm=True, host_ops=True):
    """Mean device time of one call (after a warm-up call, unless `warm`
    is false) from torch.profiler's device rows (the card's own kernel and
    memset times, without the host's issue gaps), and the names of those
    rows; appends the device operations a call to `ops_out` where given.
    With `host_ops` false the window records the card's activity only (no
    aten rows, so fewer records for a long solve). A window in which the profiler recorded no
    device row at all (seen once on the H100), or one in which a row's
    launches are not a whole multiple of `reps`, is taken again, four
    times at most; a fifth such window raises, so no unmeasured 0 is
    reported. The launches start `GUARD_S` after the window opens and it
    closes `GUARD_S` after the card is idle: on the H100 windows with no
    such margin lost the launches at their start (one kept 5 of 20)."""
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    for attempt in range(5):
        with profile(activities=[ProfilerActivity.CPU] * host_ops
                     + [ProfilerActivity.CUDA]) as prof:
            time.sleep(GUARD_S)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(GUARD_S)
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
        if rows and all(e.count % reps == 0 for e in rows):
            break
        print(f"  profiler window {attempt + 1} not whole ({reps} calls): "
              f"{[(e.key[:40], e.count) for e in rows][:6]}; taken again")
    else:
        raise RuntimeError("torch.profiler recorded no whole window in "
                           "five")
    us = sum(e.self_device_time_total for e in rows)
    if ops_out is not None:
        ops_out.append(sum(e.count for e in rows) / reps)
    return us / 1e3 / reps, [
        f"{e.key[:48]} x{e.count // reps} "
        f"{e.self_device_time_total / reps:.2f} us" for e in rows]


def check_fast(levels, ks, tag, timed=False):
    """K2 against its plain version on one frame's pyramid: the one call
    over every level, as extraction makes it, equal to the plain version
    exactly in every score plane, raw and pos, and so in every level's
    selected (ys, xs, response, valid); then each level alone through the
    one-level `detect_two_threshold`. With `timed`, CUDA events time the
    call and the plain version, and the bound is counted."""
    from orb_slam2_refactored_tpu_torch.ops import fast
    from orb_slam2_refactored_tpu_torch.ops.orb import (
        EDGE_MARGIN, topk_from_ranks)

    def call():
        return fast.detect_and_rank(levels, 20.0, 7.0, ks, margin=EDGE_MARGIN)

    def plain():
        return fast.detect_and_rank_plain(levels, 20.0, 7.0, ks,
                                          margin=EDGE_MARGIN)

    out, ref = call(), plain()
    torch.cuda.synchronize()
    err, nbytes, ops, n_rounds = 0.0, 0, {}, 0
    for lvl, k, a, b in zip(levels, ks, out, ref):
        h, w = lvl.shape
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape, (h, w)
            err = max(err, float((x.double() - y.double()).abs().max())
                      if x.numel() else 0.0)
        sel = [bool(torch.equal(x, y)) for x, y in zip(
            topk_from_ranks(a[1], a[2], k, h, w),
            topk_from_ranks(b[1], b[2], k, h, w))]
        one = fast.detect_two_threshold(lvl, 20.0, 7.0, margin=EDGE_MARGIN)
        e1 = float((one - b[0]).abs().max())
        R, C = a[1].shape
        n_rounds += R
        print(f"  K2 {tag} {h}x{w}: corners {int((a[0] > 0).sum())}, "
              f"{R} rank rounds x {C} cells, (ys, xs, resp, valid) equal "
              f"{sel}, one-level call max_abs_err {e1}")
        assert all(sel), f"K2 selection differs on {h}x{w}"
        err = max(err, e1)
        # f32 image in, f32 score plane and the rounds' (raw, pos) out.
        # Each pixel off the 3-px border: 16 differences, the 16 nine-long
        # arc minima of the bright test and maxima of the dark one at 4 ops
        # a window (the doubling cascade), 2 x 15 to reduce the arcs, a
        # negation, the max of the two and the initial-threshold test (2):
        # 178. Every pixel: the cell's threshold, subtract and clamp (3),
        # the NMS's 8 maxima, the 1e-9 floor and the compare (10). Each rank
        # round of a cell: an argmax over its 1024 pixels, a value compare
        # (f32) and an index select (int32) each.
        nbytes += h * w * 8 + R * C * 8
        add_ops(ops, f32=178 * (h - 6) * (w - 6) + 13 * h * w + R * C * 1024,
                int32=R * C * 1024)
    print(f"  K2 {tag}: {len(levels)} levels, {n_rounds} rank rounds, "
          f"max_abs_err {err}")
    assert err == 0.0, f"K2 disagrees with its plain version: {err}"
    if not timed:
        return err
    return err, cuda_time_ms(call, 50), cuda_time_ms(plain, 5), nbytes, ops


def level_keypoints(levels, ks):
    """Every level's clamped (ys, xs) as extraction selects them (plain
    versions), concatenated in budget order."""
    from orb_slam2_refactored_tpu_torch.ops import fast, orb

    sel = orb.spread_topk_levels_plain(
        [(r, p) for _, r, p in fast.detect_and_rank_plain(
            levels, 20.0, 7.0, ks, margin=orb.EDGE_MARGIN)], ks,
        [tuple(x.shape) for x in levels], list(range(len(levels))),
        [1.0] * len(levels))
    return sel.ys, sel.xs


def check_orb(levels, ys, xs, ks, tag, timed=False):
    """K3 against its plain version on one frame's keypoints: the one
    launch over every level's keypoints, as extraction makes it, with
    descriptor bits >= 99.9 % and angle bins >= 99 % equal (the moments sum
    in another order); each level's slice also through the one-level
    `angles_and_descriptors_raw`, which must equal the one-launch result.
    With `timed`, CUDA events time the launch and the plain version, and
    the bound is counted."""
    from orb_slam2_refactored_tpu_torch.ops import orb

    def call():
        return orb.angles_and_descriptors_levels(levels, ys, xs, ks)

    def plain():
        return orb.angles_and_descriptors_levels_plain(levels, ys, xs, ks)

    ak, dk = call()
    ap, dp = plain()
    torch.cuda.synchronize()
    d = torch.remainder(ak - ap + math.pi, 2 * math.pi) - math.pi
    worst_ang = float(d.abs().max())
    xor = torch.bitwise_xor(dk, dp).cpu().numpy().view(np.uint8)
    bits = float(1.0 - np.unpackbits(xor).mean())
    scale = orb.N_ANGLE_BINS / (2 * math.pi)
    bk = torch.floor((ak + math.pi) * scale).long() % orb.N_ANGLE_BINS
    bp = torch.floor((ap + math.pi) * scale).long() % orb.N_ANGLE_BINS
    bins = float((bk == bp).float().mean())
    moment_px = int(orb.circular_patch_masks()[0].sum())
    r = orb.HALF_PATCH + 3
    win = torch.arange(-r, r + 1, device=ys.device)
    nbytes, ops, start = 0, {}, 0
    for lvl, K in zip(levels, ks):
        h, w = lvl.shape
        sl = slice(start, start + K)
        start += K
        a1, d1 = orb.angles_and_descriptors_raw(lvl, ys[sl], xs[sl])
        same = bool(torch.equal(a1, ak[sl]) and torch.equal(d1, dk[sl]))
        print(f"  K3 {tag} {h}x{w} K={K}: one-level launch equal {same}")
        assert same, f"K3 one-level launch differs on {h}x{w}"
        # bytes: the level's pixels under the union of the 37x37 windows
        # (f32), the coordinates in, the angle and 8 descriptor words out
        covered = torch.zeros((h, w), dtype=torch.bool, device=lvl.device)
        covered[(ys[sl, None, None] + win[None, :, None]).long(),
                (xs[sl, None, None] + win[None, None, :]).long()] = True
        nbytes += int(covered.sum()) * 4 + K * 8 + K * 36
        # f32 per keypoint: the separable 7-tap blur (37x31 then 31x31
        # outputs, one FMA a tap), two moment FMAs per pixel of the
        # circular patch, a subtract and a compare per test
        add_ops(ops, f32=K * ((37 * 31 + 31 * 31) * 7 + 2 * moment_px
                              + 256 * 2))
    print(f"  K3 {tag}: {ys.shape[0]} keypoints on {len(levels)} levels, "
          f"angle max_abs_err {worst_ang:.3g} rad, bits equal {bits:.5f}, "
          f"bins equal {bins:.4f}")
    assert bits >= 0.999, f"K3 descriptor bits equal {bits} < 0.999"
    assert bins >= 0.99, f"K3 angle bins equal {bins} < 0.99"
    if not timed:
        return worst_ang
    return (worst_ang, cuda_time_ms(call, 50), cuda_time_ms(plain, 5),
            nbytes, ops)


def pyramid_work(shapes):
    """Bytes and operations of one pyramid (K8's function): level 0 read
    once, levels 1 to n-1 written once (the taps follow from the sizes, so
    K8's tables are not counted); one FMA a tap of every vertical output
    (output rows x input columns) and of every horizontal one."""
    from orb_slam2_refactored_tpu_torch.ops import image as image_ops

    nbytes, fma = 4 * shapes[0][0] * shapes[0][1], 0
    for (ih, iw), (oh, ow) in zip(shapes[:-1], shapes[1:]):
        nbytes += 4 * oh * ow
        for n_in, n_out, other in ((ih, oh, iw), (iw, ow, oh)):
            idx, _ = image_ops.resize_taps(n_in, n_out)
            fma += int(idx[:, 1].sum()) * other
    return nbytes, {"f32": fma}


def resident_gemm_pyramid(shape, n_levels, scale_factor, device):
    """K8's library call: the plain version's products (`resize_bilinear`:
    `wh.T @ x`, then `@ ww`, a product skipped where an axis keeps its
    size) with the dense weights already on the card, so no upload; a
    callable on an f32 image of `shape`."""
    from orb_slam2_refactored_tpu_torch.ops import image as image_ops

    shapes = image_ops.pyramid_shapes(*shape, n_levels, scale_factor)
    weights = [tuple(None if a == b else torch.as_tensor(
        image_ops._resize_weights_np(a, b), device=device) for a, b in
        ((ih, oh), (iw, ow))) for (ih, iw), (oh, ow) in zip(shapes[:-1],
                                                           shapes[1:])]

    def call(gray):
        levels = [gray]
        for wh, ww in weights:
            x = levels[-1] if wh is None else wh.T @ levels[-1]
            levels.append(x if ww is None else x @ ww)
        return levels

    return call


def pyramid_agreement(a, b):
    """Per level max |a - b| and the share of bit-equal pixels (counted
    exactly: 1.0 only where every pixel is equal)."""
    return ([float((x - y).abs().max()) for x, y in zip(a, b)],
            [int((x == y).sum()) / x.numel() for x, y in zip(a, b)])


def gemm_cuts(shapes, device_str):
    """Per level pair and pass, the input indices at which the card's GEMM
    splits an output's taps (`gemm_tap_splits`): the first few, and how
    many outputs a pass splits."""
    from orb_slam2_refactored_tpu_torch.ops import image as image_ops

    out = {}
    for (ih, iw), (oh, ow) in zip(shapes[:-1], shapes[1:]):
        for tag, n_in, n_out, other, vertical in (
                ("v", ih, oh, iw, True), ("h", iw, ow, oh, False)):
            idx, _ = image_ops.resize_taps(n_in, n_out)
            split = image_ops.gemm_tap_splits(n_in, n_out, other, vertical,
                                              device_str)
            cut = split < idx[:, 1]
            cuts = np.unique(idx[cut, 0] + split[cut]).tolist()
            out[f"{tag} {n_in}->{n_out}"] = {"outputs": int(cut.sum()),
                                             "cuts": cuts[:6]}
    return out


def unsplit_shares(gray, n_levels, scale_factor):
    """K8 with every output's taps as one chain (the GEMM's splits not
    applied): each level's bit-equal share against the plain version. The
    tap tables are rebuilt for it and rebuilt again after."""
    from orb_slam2_refactored_tpu_torch.ops import image as image_ops

    found = image_ops.gemm_tap_splits
    caches = (image_ops._tap_records, image_ops._pyramid_plan)
    image_ops.gemm_tap_splits = lambda n_in, n_out, *a: image_ops.resize_taps(
        n_in, n_out)[0][:, 4]
    try:
        for c in caches:
            c.cache_clear()
        one = image_ops.build_pyramid(gray, n_levels, scale_factor)
        ref = image_ops.build_pyramid_plain(gray, n_levels, scale_factor)
        torch.cuda.synchronize()
        return pyramid_agreement(one, ref)
    finally:
        image_ops.gemm_tap_splits = found
        for c in caches:
            c.cache_clear()


def check_pyramid(gray, frames, n_levels, scale_factor, t_plan):
    """K8 against its plain version on the card: frame 0's levels within
    1e-4 gray, the bit-equal share of each level printed; then every frame
    of cell A's (`frames`, uint8), each level's largest difference and
    bit-equal share over them and the frames bit-equal on every level.
    CUDA events time K8, the plain version and the library call (the
    plain version's GEMMs with the weights on the card,
    `resident_gemm_pyramid`), which must equal K8 bit for bit. `t_plan`
    is the seconds the extractor's construction took to build K8's
    tables. Returns K8's row (error, card ms, plain ms, bytes, ops), the
    library's ms and the library callable."""
    from orb_slam2_refactored_tpu_torch.ops import image as image_ops

    def call():
        return image_ops.build_pyramid(gray, n_levels, scale_factor)

    def plain():
        return image_ops.build_pyramid_plain(gray, n_levels, scale_factor)

    gemms = resident_gemm_pyramid(tuple(gray.shape), n_levels, scale_factor,
                                  gray.device)

    def library():
        return gemms(gray)

    out, ref = call(), plain()
    torch.cuda.synchronize()
    print(f"  K8's tables (the GEMM's splits found by probes) built at the "
          f"extractor's construction in {t_plan:.3f} s; outputs no split "
          f"explains: "
          f"{sum(image_ops.SPLIT_MISSES.values())}; the GEMM's cuts "
          + json.dumps(gemm_cuts([tuple(x.shape) for x in out],
                                 str(gray.device))))
    one_err, one_share = unsplit_shares(gray, n_levels, scale_factor)
    print(f"  K8 with one chain an output (no split): max_abs_err per level "
          f"{one_err}, bit-equal share per level {one_share}")
    err, share = pyramid_agreement(out, ref)
    shapes = [tuple(x.shape) for x in out]
    print(f"  K8 frame 0 {shapes}: max_abs_err per level {err}, bit-equal "
          f"share per level {share}")
    assert max(err) <= 1e-4, f"K8 differs from its plain version: {err}"
    worst, low, mean = [0.0] * n_levels, [1.0] * n_levels, [0.0] * n_levels
    whole = 0
    for f in frames:
        g = image_ops.to_gray(torch.as_tensor(f, device=gray.device))
        e, sh = pyramid_agreement(image_ops.build_pyramid(
            g, n_levels, scale_factor), image_ops.build_pyramid_plain(
                g, n_levels, scale_factor))
        worst = [max(a, b) for a, b in zip(worst, e)]
        low = [min(a, b) for a, b in zip(low, sh)]
        mean = [a + b / len(frames) for a, b in zip(mean, sh)]
        whole += all(x == 1.0 for x in sh)
    print(f"  K8 over {len(frames)} frames: max_abs_err per level {worst}, "
          f"bit-equal share per level min {low} mean {mean}, frames "
          f"bit-equal on every level {whole}")
    assert max(worst) <= 1e-4, f"K8 differs from its plain version: {worst}"
    lib = library()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(lib, out)), \
        "the resident GEMMs differ from K8"
    nbytes, ops = pyramid_work(shapes)
    r = (max(err), cuda_time_ms(call, 50), cuda_time_ms(plain, 20), nbytes,
         ops)
    lib_ms = cuda_time_ms(library, 50)
    b_ms, b_by = bound_ms(nbytes, ops)
    print(f"  K8: card {r[1]:.5f} ms, plain {r[2]:.5f} ms, bound "
          f"{b_ms:.6f} ms ({b_by}); the library call (the plain version's "
          f"{2 * (n_levels - 1)} GEMMs, weights on the card, bit-equal to "
          f"K8) {lib_ms:.5f} ms")
    return r, lib_ms, library


@contextlib.contextmanager
def counting_plan_builds(builds):
    """Inside the block, every K8, K9 or K7 call that had to build its
    geometry's tables (K8's GEMM probes and uploads, K9's launch table,
    K7's launch table, or K7's table of level addresses for levels laid out
    otherwise than K8 writes them) instead of finding them built by the
    extractor's construction adds one to builds[0]."""
    from orb_slam2_refactored_tpu_torch.ops import image as image_ops
    from orb_slam2_refactored_tpu_torch.ops import orb

    wrapped = ((image_ops, "pyramid_levels", image_ops._pyramid_plan),
               (orb, "spread_topk_levels", orb._spread_plan),
               (orb, "angles_and_descriptors_learned_levels",
                orb._learned_plan))
    call_table = orb._learned_call_table

    def on_the_call(*args):
        builds[0] += 1
        return call_table(*args)
    reals = [getattr(mod, name) for mod, name, _ in wrapped]

    def counted(real, cache):
        def call(*args, **kwargs):
            before = cache.cache_info().misses
            out = real(*args, **kwargs)
            builds[0] += cache.cache_info().misses - before
            return out
        return call

    for (mod, name, cache), real in zip(wrapped, reals):
        setattr(mod, name, counted(real, cache))
    orb._learned_call_table = on_the_call
    try:
        yield builds
    finally:
        for (mod, name, _), real in zip(wrapped, reals):
            setattr(mod, name, real)
        orb._learned_call_table = call_table


def topk_work(ranked, ks):
    """Bytes and operations of the spread top-k (K9's function): each
    candidate's raw response read once (its key needs nothing else), the
    pos of the k selected read and 25 bytes written a keypoint; a key a
    candidate (a compare and an add), n log2 n compares to order a level's
    n keys, ~20 integer operations to decode and clamp a keypoint."""
    nbytes, f32, i32 = 0, 0, 0
    for (raw, _), k in zip(ranked, ks):
        n = raw.numel()
        if k <= 0 or n == 0:
            continue
        nbytes += 4 * n + (4 + 25) * k
        f32 += 2 * n + 2 * k
        i32 += int(n * math.ceil(math.log2(max(n, 2)))) + 20 * k
    return nbytes, {"f32": f32, "int32": i32}


def sort_topk(ranked, ks, rank_rounds=4):
    """K9's library call: one batched `torch.sort(keys, dim=-1,
    descending=True, stable=True)` over every level's keys (padded to the
    longest level with -inf, below every key), then the first k of each
    level: (values, flat indices) a level with a budget. The keys are
    built before, as the plain version builds them."""
    from orb_slam2_refactored_tpu_torch.ops import orb

    used = [(raw, k) for (raw, _), k in zip(ranked, ks) if k > 0]
    n = max(raw.numel() for raw, _ in used)
    keys = torch.full((len(used), n), -math.inf, dtype=torch.float32,
                      device=used[0][0].device)
    for row, (raw, _) in zip(keys, used):
        boost = orb._round_boost(raw.shape[0], rank_rounds, str(raw.device))
        row[:raw.numel()] = torch.where(raw > 0, boost + raw,
                                        torch.full_like(raw, -1.0)).reshape(-1)

    def call():
        v, i = torch.sort(keys, dim=-1, descending=True, stable=True)
        return [(v[l, :k], i[l, :k]) for l, (_, k) in enumerate(used)]

    def plain():
        return [orb._topk_lowest_index(row[:raw.numel()], k)
                for row, (raw, k) in zip(keys, used)]

    return call, plain


def check_topk(levels, ks, scales, tag, timed=False):
    """K9 against its plain version on the card, on the rank rounds of one
    K2 call over `levels`, as extraction makes it: every output bit for
    bit. With `timed`, CUDA events time both and the library call
    (`sort_topk`, whose selection must equal the plain version's), and the
    bound is counted; returns K9's row, the library's ms and the library
    callable."""
    from orb_slam2_refactored_tpu_torch.ops import fast, orb

    k2 = fast.detect_and_rank(levels, 20.0, 7.0, ks, margin=orb.EDGE_MARGIN)
    ranked = [(r, p) for _, r, p in k2]
    args = (ranked, ks, [tuple(x.shape) for x in levels],
            list(range(len(levels))), scales)

    def call():  # as extraction calls it, on K2's own buffers
        return orb.spread_topk_levels(*args, buffers=k2.buffers)

    def plain():
        return orb.spread_topk_levels_plain(*args)

    out, ref = call(), plain()
    torch.cuda.synchronize()
    same = {f: bool(a.dtype == b.dtype and torch.equal(a, b))
            for f, a, b in zip(orb.SpreadTopk._fields, out, ref)}
    print(f"  K9 {tag}: {len(levels)} levels, candidates "
          f"{[r.numel() for r, _ in ranked]}, {int(out.valid.sum())} valid "
          f"of {sum(ks)}, bit for bit {same}")
    assert all(same.values()), f"K9 differs from its plain version: {same}"
    if not timed:
        return 0.0
    library, lib_plain = sort_topk(ranked, ks)
    lib_same = all(torch.equal(a, c) and torch.equal(b, d) for (a, b), (c, d)
                   in zip(library(), lib_plain()))
    print(f"  K9's library call (one stable torch.sort over the padded "
          f"[{len(ranked)}, {max(r.numel() for r, _ in ranked)}] keys): "
          f"the plain version's selection {lib_same}")
    assert lib_same, "the stable sort selects otherwise"
    nbytes, ops = topk_work(ranked, ks)
    r = (0.0, cuda_time_ms(call, 50), cuda_time_ms(plain, 20), nbytes, ops)
    return r, cuda_time_ms(library, 50), library


def _clone(v):
    if isinstance(v, torch.Tensor):
        return v.clone()
    if isinstance(v, list):
        return [_clone(x) for x in v]
    if isinstance(v, tuple) and hasattr(v, "_fields"):
        return type(v)(*(_clone(x) for x in v))
    return v


@contextlib.contextmanager
def recording(calls, *targets, like=None):
    """Inside the block, every call of the function that the (module,
    attribute) `targets` name appends a copy of its arguments to `calls`,
    named as the parameters of `like` (default: the function's own)."""
    real = getattr(*targets[0])
    sig = inspect.signature(like or real)

    def record(*args, **kwargs):
        bound = sig.bind(*args, **kwargs).arguments
        calls.append({k: _clone(v) for k, v in bound.items()
                      if v is not None})
        return real(*args, **kwargs)

    for mod, attr in targets:
        setattr(mod, attr, record)
    try:
        yield calls
    finally:
        for mod, attr in targets:
            setattr(mod, attr, real)


def recording_k1(calls):
    """The matchers, triangulation and fusion reach K1 as
    `hamming.masked_best2_gated`."""
    from orb_slam2_refactored_tpu_torch.ops import hamming

    return recording(calls, (hamming, "masked_best2_gated"))


def recording_k4(calls):
    """The step reaches K4 as `tracking.pose_optimize`."""
    from orb_slam2_refactored_tpu_torch.optim import pose_opt
    from orb_slam2_refactored_tpu_torch.slam import tracking

    return recording(calls, (pose_opt, "pose_optimize"),
                     (tracking, "pose_optimize"))


def name_k1_calls(tag, calls):
    return {f"{tag}{i}_{a['q'].shape[0]}x{a['t'].shape[0]}"
            + ("_window" if "uv" in a else "")
            + ("_pair" if "pair_ok" in a else ""): a
            for i, a in enumerate(calls)}


def check_hamming(cases, per_frame):
    """K1 against its plain version on the arguments the matchers really
    passed it; time and bound the calls of one tracked frame (`per_frame`)."""
    from orb_slam2_refactored_tpu_torch.ops import hamming

    err, ms, plain_ms, nbytes, ops = 0, 0.0, 0.0, 0, {}
    for name, a in cases.items():
        k = hamming.masked_best2_gated(**a)
        p = hamming.masked_best2_gated_plain(**a)
        torch.cuda.synchronize()
        e = max(int((x.long() - y.long()).abs().max()) for x, y in zip(k, p))
        M, N = a["q"].shape[0], a["t"].shape[0]
        mask = hamming.candidate_mask(
            a["row_ok"], a["col_ok"], a.get("uv"), a.get("rad"),
            a.get("lvl_r"), a.get("xy"), a.get("lvl_c"), a.get("pair_ok"))
        n_pass = int(mask.sum())
        matched = int((k[1] < hamming.BIG).sum())
        rows, cells, tested = (int(w) for w in hamming.hamming_work(**a))
        print(f"  K1 hamming {name}: max_abs_err {e} rows passing "
              f"{int(a['row_ok'].sum())} candidate pairs {n_pass} "
              f"rows matched {matched}; the kernel searched {rows} rows, "
              f"read {cells} grid cells, tested {tested} target records")
        err = max(err, e)
        if name in per_frame:
            ms += cuda_time_ms(lambda: hamming.masked_best2_gated(**a), 50)
            plain_ms += cuda_time_ms(
                lambda: hamming.masked_best2_gated_plain(**a), 10)
            gated = "uv" in a
            # descriptors, validity and (gated) window inputs read once,
            # (idx, best, second) written once
            nbytes += M * 32 + N * 32 + M + N + 12 * M
            if gated:
                nbytes += M * 16 + N * 12
            # each pair of a valid row and a valid column, window gate: 2
            # subtractions, 2 products, a sum and a compare (f32), the level
            # test (subtract, abs, compare) and an AND. Each candidate pair:
            # 8 XOR and 8 POPC, 7 adds, the compares with the best and the
            # second best (2).
            valid_pairs = int(a["row_ok"].sum()) * int(a["col_ok"].sum())
            add_ops(ops, f32=6 * valid_pairs if gated else 0,
                    int32=(4 * valid_pairs if gated else 0) + 17 * n_pass,
                    popc=8 * n_pass)
    assert err == 0, f"K1 disagrees with its plain version: {err}"
    return err, ms, plain_ms, nbytes, ops


def pose_cost_f64(pose, inliers, a):
    """The final cost of the pose LM (chi2 summed over `inliers`, no
    Huber) at `pose`, computed in f64 by the plain residuals."""
    from orb_slam2_refactored_tpu_torch.optim import pose_opt

    has_ur = a["obs_ur"] > 0
    obs_uvr = torch.cat([a["obs_uv"], torch.where(
        has_ur, a["obs_ur"], torch.zeros_like(a["obs_ur"]))[:, None]], -1)
    r, _ = pose_opt._residuals(pose.double(), a["pts_w"].double(),
                               obs_uvr.double(), has_ur, a["cam"])
    chi2 = (r * r).sum(-1) * a["inv_sigma2"].double()
    return float(chi2[inliers].sum())


def check_pose_lm(cases, per_frame):
    """K4 against its plain version on the arguments the step really passed
    it: pose within 1e-5 m / 1e-5 rad, or else the same minimum one LM step
    apart (pose within 1e-4 m / 3e-5 rad, no inlier flip, and the cost of
    the two poses, both evaluated in f64 by the plain residuals over the
    plain version's inliers, within 1e-5 relative of each other); inliers
    >= 99.9 % equal with a flip only where chi2 lies within 1e-4 relative
    of its threshold. Time and bound the calls of one tracked frame
    (`per_frame`).

    Why "one LM step apart": the LM takes a step only where its f32 cost
    sum drops, and stops once the relative gain is below 1e-5. Near
    convergence K4 and the plain version sum that cost in different
    orders, so one of them can take a last step the other refuses, and they
    stop one step apart along a direction the cost barely constrains. On
    the local-BA path, whose map varies in the last bits from run to run
    (f32 atomics), that put the two 1.5e-5 to 6.7e-5 m and up to 2.0e-5 rad
    apart on the recorded frame in about half of the runs (on an H100)."""
    from orb_slam2_refactored_tpu_torch.geometry import se3
    from orb_slam2_refactored_tpu_torch.optim import pose_opt

    err, ms, plain_ms, nbytes, ops = 0.0, 0.0, 0.0, 0, {}
    n_flip = n_obs = 0
    for name, a in cases.items():
        k = pose_opt.pose_optimize(**a)
        p = pose_opt.pose_optimize_plain(**a)
        torch.cuda.synchronize()
        d = se3.log(se3.compose(k.pose, se3.inverse(p.pose)))
        rot, trans = float(d[:3].abs().max()), float(d[3:].abs().max())
        flips = k.inliers != p.inliers
        has_ur = a["obs_ur"] > 0
        r, _ = pose_opt._residuals(
            p.pose, a["pts_w"], torch.cat([a["obs_uv"], torch.where(
                has_ur, a["obs_ur"], torch.zeros_like(a["obs_ur"]))[:, None]],
                -1), has_ur, a["cam"])
        chi2 = (r * r).sum(-1) * a["inv_sigma2"]
        th = torch.where(has_ur, torch.full_like(chi2, pose_opt.CHI2_STEREO),
                         torch.full_like(chi2, pose_opt.CHI2_MONO))
        near = (chi2 - th).abs() <= 1e-4 * th
        bad_flips = int((flips & ~near).sum())
        live = [(int(i), int(n)) for i, n in pose_opt.pose_lm_work(**a)]
        c_k, c_p = (pose_cost_f64(pose, p.inliers, a)
                    for pose in (k.pose, p.pose))
        cost_rel = abs(c_k - c_p) / max(abs(c_p), 1e-300)
        print(f"  K4 pose_lm {name}: rot {rot:.3g} rad trans {trans:.3g} m, "
              f"f64 cost at the two poses {c_k:.9g} vs {c_p:.9g} "
              f"(relative {cost_rel:.3g}), "
              f"inliers {int(k.num_inliers)} vs {int(p.num_inliers)}, "
              f"flips {int(flips.sum())}, (iterations, observations) a "
              f"round {live}")
        one_step = (rot <= 3e-5 and trans <= 1e-4 and cost_rel <= 1e-5
                    and not bool(flips.any()))
        assert (rot <= 1e-5 and trans <= 1e-5) or one_step, \
            (name, rot, trans, cost_rel)
        assert bad_flips == 0, f"K4 {name}: {bad_flips} flips off threshold"
        n_flip += int(flips.sum())
        n_obs += flips.numel()
        err = max(err, float((k.pose - p.pose).abs().max()))
        if name in per_frame:
            ms += cuda_time_ms(lambda: pose_opt.pose_optimize(**a), 50)
            plain_ms += cuda_time_ms(
                lambda: pose_opt.pose_optimize_plain(**a), 5)
            N = a["pts_w"].shape[0]
            # pose, points, (u, v), u_r, 1/sigma^2 and validity read once;
            # pose, inliers, count and cost written once
            nbytes += 28 + 29 * N + 28 + N + 8
            # ~300 f32 an active observation an iteration (residual and
            # Jacobian, 21 + 6 weighted products, the candidate's residual),
            # ~60 an observation for each reclassification and the final cost
            add_ops(ops, f32=sum(300 * i * n for i, n in live)
                    + 60 * N * (len(live) + 1))
    assert n_flip <= 1e-3 * n_obs, f"K4 inliers: {n_flip} of {n_obs} differ"
    return err, ms, plain_ms, nbytes, ops


def check_reloc(rec, tracker):
    """Phase 4 on cell D's recorded relocalization (`rec`) and vocabulary
    training: every K1 call (quantization, the two-way descriptor matching
    of each candidate, the polish's projection search) bit for bit against
    the plain version and every K4 call (the candidates' LM and polish)
    through `check_pose_lm`, each call timed alone and bounded; the
    vocabulary trained again on the card from the recorded descriptors
    equal to the tracker's bit for bit, and the plain path on the CPU equal
    to it bit for bit, with the six training K1 calls bit for bit against
    the plain version; `compute_bow` on the card equal to its plain version
    exactly on the recovering frame and on every indexed keyframe, and its
    scores within 1e-6 (common words exact)."""
    from orb_slam2_refactored_tpu_torch.slam import vocabulary as vocab

    shapes, rec["timed"] = {}, {}

    def one_k1(name, a):
        r = check_hamming({name: a}, per_frame={name: a})
        b, by = bound_ms(r[3], r[4])
        shapes[name] = {"ms": r[1], "plain_ms": r[2], "bound_ms": b,
                        "bound_by": by}
        rec["timed"][name] = ("k1", a)

    for name, a in name_k1_calls("reloc", rec["k1"]).items():
        one_k1(name, a)
    k4 = {f"reloc{i}_{'polish' if 'rounds' in a else 'lm'}": a
          for i, a in enumerate(rec["k4"])}
    k4_err = 0.0
    for name, a in k4.items():
        r = check_pose_lm({name: a}, per_frame={name: a})
        b, by = bound_ms(r[3], r[4])
        shapes[name] = {"ms": r[1], "plain_ms": r[2], "bound_ms": b,
                        "bound_by": by}
        rec["timed"][name] = ("k4", a)
        k4_err = max(k4_err, r[0])

    tr = rec["train"]
    kw = {"n_words": tr["n_words"], "iters": tr["iters"]}
    train_k1 = []
    t0 = time.perf_counter()
    with recording_k1(train_k1):
        card = vocab.train_vocabulary(tr["descriptors"], device=tracker.device,
                                      **kw)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = vocab.train_vocabulary(tr["descriptors"], device="cpu", **kw)
    plain_s = time.perf_counter() - t0
    same = {"card vs the tracker's": bool(torch.equal(
        card.words, tracker.vocabulary.words)),
        "plain (CPU) vs card": bool(torch.equal(plain.words,
                                                 card.words.cpu()))}
    print(f"  vocabulary: {len(tr['descriptors'])} descriptors, "
          f"{card.n_words} words, {len(train_k1)} K1 calls; trained again "
          f"on the card in {card_s:.3f} s, on the CPU (plain) in "
          f"{plain_s:.3f} s; words bit-equal {json.dumps(same)}")
    assert all(same.values()), same
    assert len(train_k1) == tr["iters"], len(train_k1)
    train_calls = name_k1_calls("train", train_k1)
    check_hamming(train_calls, per_frame={})
    one_k1(*next(iter(train_calls.items())))

    db, frame, m = rec["db"], rec["frame"], rec["map"]
    cpu_db = snapshot_db(db)
    cpu_db.voc = vocab.Vocabulary(db.voc.words.cpu(), db.voc.idf.cpu())
    cpu_db.bow_ids, cpu_db.bow_cnt = db.bow_ids.cpu(), db.bow_cnt.cpu()
    cpu_db.idf = db.idf.cpu()
    (ids, cnt), word = db.compute_bow(frame.desc, frame.valid)
    (ids_p, cnt_p), word_p = cpu_db.compute_bow(frame.desc.cpu(),
                                                frame.valid.cpu())
    bow_same = [bool(torch.equal(x.cpu(), y))
                for x, y in ((ids, ids_p), (cnt, cnt_p), (word, word_p))]
    rows_same = 0
    active = np.nonzero(db.active)[0]
    for kf in active:
        (ri, rc), _ = cpu_db.compute_bow(m.kf_desc[int(kf)].cpu(),
                                         m.kf_feat_valid[int(kf)].cpu())
        rows_same += int(torch.equal(ri, db.bow_ids[kf].cpu())
                         and torch.equal(rc, db.bow_cnt[kf].cpu()))
    s, c = db.score_query((ids, cnt))
    s_p, c_p = cpu_db.score_query((ids_p, cnt_p))
    s_err = float((s.cpu() - s_p).abs().max())
    print(f"  compute_bow on the card vs plain: recovering frame (ids, counts, "
          f"words) equal {bow_same} ({int((ids < db.voc.n_words).sum())} "
          f"words); {rows_same} of {len(active)} indexed keyframes' rows "
          f"equal; scores max_abs_err {s_err:.3g}, common words equal "
          f"{bool(torch.equal(c.cpu(), c_p))}")
    assert all(bow_same) and rows_same == len(active)
    assert s_err <= 1e-6 and torch.equal(c.cpu(), c_p)
    print("relocalization and training kernel calls " + json.dumps(shapes))
    return shapes, k4_err


def reloc_breakdown(rec, tracker, reps=20):
    """Phase 5: device time, device operations and kernel launches of each
    stage of cell D's recorded relocalization (BoW build, scoring, then per
    candidate the descriptor match, the RANSAC, the LM and the polish), on
    the map and database as they were, and the device time of each K1 and
    K4 call that `check_reloc` timed; its host time on the recovering frame
    was taken in phase 3."""
    from orb_slam2_refactored_tpu_torch import kernels
    from orb_slam2_refactored_tpu_torch.ops import hamming
    from orb_slam2_refactored_tpu_torch.optim import pose_opt
    from orb_slam2_refactored_tpu_torch.solvers import ransac

    calls_ms = {}
    for name, (kind, a) in rec["timed"].items():
        fn = (hamming.masked_best2_gated if kind == "k1"
              else pose_opt.pose_optimize)
        calls_ms[name] = profiled_ms(lambda: fn(**a), reps)[0]
    print("relocalization and training kernel calls, device ms a call "
          + json.dumps(calls_ms))

    frame, m, db = rec["frame"], rec["map"], rec["db"]
    v = db.compute_bow(frame.desc, frame.valid)[0]
    stages = [("bow_build", lambda: db.compute_bow(frame.desc, frame.valid)),
              ("scoring", lambda: db.score_query(v))]
    for a in rec["match"]:
        stages.append((f"match kf {a['kf']}",
                       lambda a=a: tracker._reloc_match_impl(frame, m,
                                                             a["kf"])))
    for i, a in enumerate(rec["ransac"]):
        stages.append((f"ransac {i}", lambda a=a: ransac.horn_ransac(**a)))
    for i, a in enumerate(x for x in rec["k4"] if "rounds" not in x):
        stages.append((f"lm {i}", lambda a=a: pose_opt.pose_optimize(**a)))
    for i, a in enumerate(rec["polish"]):
        stages.append((f"polish {i}", lambda a=a: tracker._reloc_polish_impl(
            frame, m, a["pose"])))
    out = {}
    for name, fn in stages:
        before = kernels.counts()
        fn()
        torch.cuda.synchronize()
        launched = {k: n - before[k] for k, n in kernels.counts().items()
                    if n != before[k]}
        ops = []
        ms, rows = profiled_ms(fn, reps, ops)
        out[name] = {"device_ms": ms, "device_ops": ops[0],
                     "kernel_launches": launched}
        print(f"  relocalization {name}: {ms:.5f} ms of device time, "
              f"{ops[0]:g} device operations, launches {launched}: "
              f"{rows[:6]}")
    # the database's two plain-torch stages: CUDA-event time, and the bound.
    # Row build: K1's share (8 popc and 17 int32 a descriptor-word pair, as
    # `check_hamming` counts) over the descriptors, their validity and the
    # words read once, the row (ids, counts) and the words written once.
    # Scoring: every row entry (id, count) read once with the query row and
    # the idf, ~10 f32 operations an entry (idf product, normalization,
    # the query gather, min, sum), scores and common counts written once.
    N, W = frame.desc.shape[0], db.voc.n_words
    KF, T = db.bow_ids.shape
    for name, nbytes, ops in (
            ("bow_build", N * 33 + W * 32 + T * 8 + N * 4,
             {"popc": 8 * N * W, "int32": 17 * N * W}),
            ("scoring", KF * T * 8 + T * 8 + W * 4 + KF * 8,
             {"f32": 10 * KF * T})):
        b, by = bound_ms(nbytes, ops)
        out[name].update(card_ms=cuda_time_ms(dict(stages)[name], 20),
                         bound_ms=b, bound_by=by)
    total = {"device_ms": sum(x["device_ms"] for x in out.values()),
             "device_ops": sum(x["device_ops"] for x in out.values()),
             "candidates_matched": len(rec["match"]),
             "host_ms_recovering_frame": rec["host_ms"]}
    print("relocalization breakdown " + json.dumps({"stages": out,
                                                    "total": total}))
    return out, total


def kf_loop_ms(tracker, tag):
    """`kf.loop`'s host time (synchronized) on the training keyframe and the
    median over the ordinary keyframes after it."""
    xs = [s * 1e3 for s in tracker.timer.samples["kf.loop"]]
    k = tracker.VOCAB_TRAIN_KFS - 1
    res = {"training_keyframe_ms": xs[k] if len(xs) > k else None,
           "ordinary_keyframe_ms_median": (float(np.median(xs[k + 1:]))
                                           if len(xs) > k + 1 else None),
           "before_training_ms": xs[:k], "keyframes": len(xs)}
    print(f"kf.loop ({tag}) " + json.dumps(res))
    return res


def _rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _f64(v):
    if isinstance(v, torch.Tensor):
        return v.double() if v.is_floating_point() else v
    if isinstance(v, tuple) and hasattr(v, "_fields"):
        return type(v)(*(_f64(x) for x in v))
    return v


def k5_agrees(name, k, r, exact, cancels=False):
    """An array of K5 agrees with its plain version when every entry lies
    within 1e-4 x the array's largest magnitude of the plain one's. For the
    one sum whose terms cancel (`cancels`: g_p near convergence, ~1000
    signed f32 terms a row, residuals that are mostly rounding) it may
    instead lie no further from the same assembly computed in f64 than
    twice the plain version's own distance from it."""
    rel = _rel_err(k, r)
    e_k = float((k.double() - exact).abs().max())
    e_p = float((r.double() - exact).abs().max())
    scale = float(exact.abs().max())
    print(f"    {name}: kernel vs plain {rel:.3g} of max |{name}|; vs f64 "
          f"sums kernel {e_k / scale:.3g}, plain {e_p / scale:.3g}")
    assert rel <= 1e-4 or (cancels and e_k <= max(1e-4 * scale, 2 * e_p)), \
        name


@contextlib.contextmanager
def deterministic():
    """Torch's deterministic algorithms inside the block (warnings only
    where an op has none); the previous setting restored on exit."""
    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(det)


def check_ba(asm_call, solve_call):
    """K5 against its plain version on the first LM iteration of one window
    BA of the main path, at its real point bucket: the point index equal
    to its plain version, every array within `k5_agrees`, and two calls of
    each entry on the same arguments (and `ba_assemble` with the index
    built by the wrapper) bit-equal; then the whole window BA with K5
    against the same solve with the plain assembly: poses within 1e-4 m /
    1e-4 rad, the plain solve run in torch's deterministic mode. Returns the
    results of `ba_point_index`, `ba_assemble` and `ba_cost`."""
    from orb_slam2_refactored_tpu_torch.geometry import se3
    from orb_slam2_refactored_tpu_torch.optim import ba

    a = asm_call
    # ba_cost's arguments
    c = {n: v for n, v in a.items() if n not in ("index", "w_obs")}
    p = a["p"]
    W, N = p.obs_uv.shape[:2]
    Q = p.pt_pos.shape[0]
    live = int(a["obs_ok"].sum())
    idx = ba.ba_point_index(p.obs_pt, a["obs_ok"], Q)
    idx_r = ba.ba_point_index_plain(p.obs_pt, a["obs_ok"], Q)
    idx_same = [bool(torch.equal(x, y)) for x, y in zip(idx, idx_r)]
    idx_same.append(bool(all(torch.equal(x, y)
                             for x, y in zip(idx, a["index"]))))
    per_pt = idx_r.offsets[1:] - idx_r.offsets[:-1]
    flat = p.obs_pt.clamp(0, Q - 1).long() + Q * torch.arange(
        W, device=p.obs_pt.device)[:, None]
    pairs = int(torch.unique(flat[a["obs_ok"]]).numel())
    print(f"  K5 ba_point_index Q={Q}: {live} live slots on "
          f"{int((per_pt > 0).sum())} points (at most {int(per_pt.max())} a "
          f"point), {live - pairs} beside another slot of their point in "
          f"their keyframe; (offsets, slots) equal to the plain version, "
          f"and the solve's index equal: {idx_same}")
    assert all(idx_same), idx_same
    k = ba.ba_assemble(**a)
    r = ba.ba_assemble_plain(**a)
    exact = ba.ba_assemble_plain(**{n: _f64(v) for n, v in a.items()})
    ck, chi2k = ba.ba_cost(**c)
    cr, chi2r = ba.ba_cost_plain(**c)
    ce, chi2e = ba.ba_cost_plain(**{n: _f64(v) for n, v in c.items()})
    repro = {
        "ba_point_index twice": all(torch.equal(x, y) for x, y in zip(
            idx, ba.ba_point_index(p.obs_pt, a["obs_ok"], Q))),
        "ba_assemble twice": all(torch.equal(x, y) for x, y in zip(
            k, ba.ba_assemble(**a))),
        "ba_assemble, index built by the wrapper": all(
            torch.equal(x, y) for x, y in zip(k, ba.ba_assemble(**c))),
        "ba_cost twice": all(torch.equal(x, y) for x, y in zip(
            (ck, chi2k), ba.ba_cost(**c))),
        "ba_cost without chi2": bool(torch.equal(
            ck, ba.ba_cost(**c, want_chi2=False)[0])),
    }
    torch.cuda.synchronize()
    print(f"  K5 bit-equal: {json.dumps(repro)}")
    assert all(repro.values()), repro
    asm_err = max(float((x - y).abs().max()) for x, y in zip(k, r))
    print(f"  K5 ba_assemble W={W} N={N} Q={Q} live observations {live}:")
    for name, x, y, z in zip(("Hpp", "g_p", "Hll|g_l", "T"), k, r, exact):
        k5_agrees(name, x, y, z, cancels=name == "g_p")
    print(f"  K5 ba_cost: cost {float(ck):.8g} vs {float(cr):.8g} "
          f"(f64 {float(ce):.8g})")
    k5_agrees("cost", ck[None], cr[None], ce[None])
    k5_agrees("chi2", chi2k, chi2r, chi2e)

    sa = dict(solve_call)
    res_k = ba.ba_solve(**sa)
    real = (ba.ba_assemble, ba.ba_cost)
    ba.ba_assemble, ba.ba_cost = ba.ba_assemble_plain, ba.ba_cost_plain
    # The plain assembly's `index_add_` sums with float atomics on the card,
    # in an order that changes from run to run; on cell C's recorded window
    # that let the plain solve take a third LM step in some runs and not in
    # others (1.6e-6 or 1.19e-4 m from the kernel's, f64 costs within 3e-7
    # relative). Torch's deterministic mode gives it one order, so the
    # reference is the same in every run.
    try:
        with deterministic():
            res_p = ba.ba_solve(**sa)
    finally:
        ba.ba_assemble, ba.ba_cost = real
    d = se3.log(se3.compose(res_k.kf_pose, se3.inverse(res_p.kf_pose)))
    rot, trans = float(d[:, :3].abs().max()), float(d[:, 3:].abs().max())
    inl = float((res_k.obs_inlier == res_p.obs_inlier).float().mean())
    # the Huber cost of both results over the same observations, in f64
    sp = sa["p"]
    p64 = _f64(sp)
    ok0 = (sp.obs_pt >= 0) & sp.pt_valid[sp.obs_pt.clamp(min=0).long()]
    huber = sa.get("use_huber", True)
    c_k, c_p = (float(ba.ba_cost_plain(r.kf_pose.double(), r.pt_pos.double(),
                                       p64, ok0, sa["cam"], huber)[0])
                for r in (res_k, res_p))
    cost_rel = abs(c_k - c_p) / max(abs(c_p), 1e-300)
    print(f"  K5 whole window BA vs plain assembly: rot {rot:.3g} rad trans "
          f"{trans:.3g} m, cost {float(res_k.initial_cost):.6g} -> "
          f"{float(res_k.final_cost):.6g} (plain -> "
          f"{float(res_p.final_cost):.6g}), f64 cost of the two results "
          f"{c_k:.9g} vs {c_p:.9g} (relative {cost_rel:.3g}), obs gate "
          f"equal {inl:.5f}")
    assert rot <= 1e-4 and trans <= 1e-4, (rot, trans, cost_rel)

    S = W * N
    index = (max(float((x - y).abs().max()) for x, y in zip(idx, idx_r)),
             cuda_time_ms(lambda: ba.ba_point_index(p.obs_pt, a["obs_ok"], Q),
                          20),
             cuda_time_ms(lambda: ba.ba_point_index_plain(
                 p.obs_pt, a["obs_ok"], Q), 5),
             # obs_pt and obs_ok read; offsets and slots written
             S * 5 + (Q + 1) * 4 + S * 4,
             # ~10 int32 a slot (clamp, count, place), a scan step a point
             {"int32": 10 * S + 2 * Q})
    in_bytes = W * 28 + Q * 12 + W * N * (8 + 4 + 4 + 4 + 1)
    asm = (asm_err,
           cuda_time_ms(lambda: ba.ba_assemble(**a), 20),
           cuda_time_ms(lambda: ba.ba_assemble_plain(**a), 5),
           # Hpp, g_p, the [Q,12] point rows and the [Q*W,18] T written
           # once (the point index is this design's, counted in its row)
           in_bytes + W * 42 * 4 + Q * 12 * 4 + Q * W * 18 * 4,
           # ~480 f32 a live observation: residual, both Jacobian blocks,
           # 21 + 6 camera products, 9 + 3 point and 18 camera-point
           # products, each weighted
           {"f32": 480 * live})
    cost = (float((chi2k - chi2r).abs().max()),
            cuda_time_ms(lambda: ba.ba_cost(**c), 20),
            cuda_time_ms(lambda: ba.ba_cost_plain(**c), 5),
            in_bytes + 4 + W * N * 4,
            # ~60 f32 a slot for the residual and chi2, ~10 more for the
            # Huber rho of a live observation
            {"f32": 60 * W * N + 10 * live})
    return index, asm, cost


def association_args(a):
    """From `stereo_associate`'s recorded arguments `a`: K1's (idx, best)
    under the stereo gate, and the arguments of the B9 launch after it
    (`associate_from_best2`)."""
    from orb_slam2_refactored_tpu_torch.ops import stereo

    gate = {k: v for k, v in a.items()
            if k not in ("levels_l", "levels_r", "max_dist")}
    idx, best = stereo._band_best2(**gate)
    tail = {k: a[k] for k in ("levels_l", "levels_r", "l_xy", "l_level",
                              "r_xy", "scale_factors", "bf")}
    tail.update(idx=idx, best=best)
    if "max_dist" in a:
        tail["max_dist"] = a["max_dist"]
    return tail


def check_stereo_sad(a):
    """B9 on the arguments the stereo step gave `stereo_associate` (`a`):
    the whole association (gate, K1, one B9 launch) bit-equal to
    `stereo_associate_plain` (the same K1, then plain torch), the B9
    launch alone (`associate_from_best2`) bit-equal to its plain version on
    the same K1 outputs, in three back-to-back calls (the ticket resets),
    and the SAD-only entry (`refine_subpixel_sad`) bit-equal to
    `refine_subpixel_sad_plain` at the coordinates the launch searches.
    CUDA events time the launch and the plain version; the bound counts
    what the function needs: the pixels under the patches and strips of
    the keypoints within the distance bound (the others are rejected
    whatever their SAD) once each, K1's outputs, the coordinates and the
    three outputs. Returns the kernel row's numbers and the launch's
    arguments."""
    from orb_slam2_refactored_tpu_torch.ops import hamming, stereo

    whole = stereo.stereo_associate(**a)
    whole_plain = stereo.stereo_associate_plain(**a)
    tail = association_args(a)

    def call():
        return stereo.associate_from_best2(**tail)

    def plain():
        return stereo.associate_from_best2_plain(**tail)

    k, k2, k3, p = call(), call(), call(), plain()
    torch.cuda.synchronize()
    same_whole = [bool(torch.equal(x, y)) for x, y in zip(whole, whole_plain)]
    same = [bool(torch.equal(x, y)) for x, y in zip(k, p)]
    thrice = all(torch.equal(x, y) and torch.equal(x, z)
                 for x, y, z in zip(k, k2, k3))
    # the coordinates the kernel searches at: the matched u before the
    # distance median, at each keypoint's level
    max_dist = tail.get("max_dist", hamming.TH_HIGH)
    ok1 = tail["best"] <= max_dist
    r_x = tail["r_xy"][:, 0]
    mu = torch.where(ok1, r_x[tail["idx"].clamp(0, r_x.shape[0] - 1).long()],
                     torch.full_like(tail["l_xy"][:, 0], -1.0))
    coords = stereo.level_coordinates(tail["levels_l"], tail["l_xy"],
                                      tail["l_level"], mu,
                                      tail["scale_factors"])
    sad_args = (tail["levels_l"], tail["levels_r"], *coords)
    sad_k = stereo.refine_subpixel_sad(*sad_args)
    sad_p = stereo.refine_subpixel_sad_plain(*sad_args)
    torch.cuda.synchronize()
    same_sad = [bool(torch.equal(x, y)) for x, y in zip(sad_k, sad_p)]
    err = max(float((x.double() - y.double()).abs().max()) for x, y in
              list(zip(k, p)) + list(zip(sad_k, sad_p)))
    lvl, yl, xl, ur0 = (c.long() for c in coords)
    N = lvl.shape[0]
    dev = lvl.device
    d11 = torch.arange(-5, 6, device=dev)
    d21 = torch.arange(-10, 11, device=dev)
    pixels = 0
    for l, (img_l, img_r) in enumerate(zip(tail["levels_l"],
                                           tail["levels_r"])):
        sel = (lvl == l) & ok1
        for img, xs, dx in ((img_l, xl, d11), (img_r, ur0, d21)):
            cov = torch.zeros(img.shape, dtype=torch.bool, device=dev)
            cov[(yl[sel, None, None] + d11[None, :, None]),
                (xs[sel, None, None] + dx[None, None, :])] = True
            pixels += int(cov.sum())
    levels = [int((lvl == l).sum()) for l in range(len(tail["levels_l"]))]
    n_ok1 = int(ok1.sum())
    print(f"  B9 stereo_sad: {N} keypoints (by level {levels}), {n_ok1} "
          f"within the distance bound, {int(k[2].sum())} accepted; the "
          f"association bit-equal to stereo_associate_plain {same_whole}; "
          f"the B9 launch (u_right, depth, ok) bit-equal to its plain "
          f"version {same}, three calls bit-equal {thrice}; the SAD-only "
          f"entry (ur_lvl, sad, delta_ok) bit-equal to its plain version "
          f"{same_sad}")
    assert all(same_whole) and all(same) and thrice and all(same_sad), (
        same_whole, same, thrice, same_sad)
    L = len(tail["levels_l"])
    # f32 pixels read once; every keypoint's best, and l_xy, l_level, idx
    # and the matched r_x of those within the distance bound, and the scale
    # factors in; u_right, depth (f32) and ok (bool) out
    nbytes = 4 * pixels + 4 * N + 20 * n_ok1 + 4 * L + 9 * N
    # a keypoint within the distance bound: each of the 11 windows' 121
    # terms, two centrings, a difference, an add of its absolute value, and
    # ~40 for the coordinates, the argmin, the parabola and the gates; each
    # median at least a look at every key for its range and one counting
    # pass (a compare, a subtraction, a shift and a count a key)
    ops = {"f32": n_ok1 * (11 * 121 * 4 + 40), "int32": 2 * 7 * N}
    return (err, cuda_time_ms(call, 50), cuda_time_ms(plain, 5), nbytes,
            ops), tail


def b9_wrapper_host_us(tail, reps=2000):
    """Host microseconds a call of B9's wrapper (`associate_from_best2`) on
    the recorded arguments: the whole call (it checks, allocates and
    issues the launch, then returns), its argument check alone, and the
    key a cache of checked signatures would build in the check's place
    (each tensor's shape, dtype, device and contiguity, and a dict
    lookup). Median of 5 runs of `reps` calls, the queue drained between
    runs."""
    from orb_slam2_refactored_tpu_torch.ops import stereo

    t = tail
    args = (t["l_xy"], t["l_level"], t["r_xy"], t["idx"], t["best"],
            t["scale_factors"], *t["levels_l"], *t["levels_r"])
    seen = {}

    def key():
        return seen.get(tuple((x.shape, x.dtype, x.device, x.is_contiguous())
                              for x in args))

    fns = {"call": lambda: stereo.associate_from_best2(**t),
           "check": lambda: stereo._check_associate(
               t["levels_l"], t["levels_r"], t["l_xy"], t["l_level"],
               t["r_xy"], t["idx"], t["best"], t["scale_factors"]),
           "signature_key": key}
    us = {}
    for name, fn in fns.items():
        runs = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            runs.append((time.perf_counter() - t0) / reps * 1e6)
        us[name] = sorted(runs)[2]
    torch.cuda.synchronize()
    print("B9 wrapper host time a call, us: " + json.dumps(us))
    return us


# ---------------------------------------------------------------------------
# phase 2 (K10): the packed frame's decode against its plain version
# ---------------------------------------------------------------------------

# the DCT image's geometries: VGA, EuRoC's 752x480 and phase 3k's cameras
WIRE_DCT_SIZES = ((480, 640), (480, 752), (1200, 1920), (2160, 3840))
# gray: JAX's own gate between its two decoders (`tests/test_codec.py:47`);
# the kernel adds the 16 products of a pixel in another order than einsum
WIRE_DCT_TOL = 1e-3


def ingest_config(**kw):
    """`bench.py:98-131`'s RGB-D tracker: the bench's configuration
    pipelined at its depth 6, with its depth wire format (log8 at
    subsample 8, `BENCH_DEPTH_ENC` and `BENCH_DEPTH_SUB`'s defaults)."""
    import dataclasses

    return dataclasses.replace(
        pipelined(bench_config(True), PIPE_DEPTHS["A"]), depth_subsample=8,
        depth_encoding="log8", **kw)


def wire_work(buf, img, dep):
    """Bytes K10 must move (the coded bytes it decodes read once, its table,
    4 bytes a decoded value written) and its f32 operations (KEEP * KEEP
    + KEEP multiply-adds a pixel of the image)."""
    from orb_slam2_refactored_tpu_torch.ops import codec

    k = buf.shape[0]
    nbytes, ops = 0, 0
    if img is not None:
        H, W = img[1:]
        nbytes += k * (codec.encoded_nbytes(H, W) + 4 * H * W)
        ops += k * H * W * (codec.KEEP * codec.KEEP + codec.KEEP)
    if dep is not None:
        h, w = dep[1:]
        nbytes += k * 5 * h * w + 4 * 256
    return nbytes, {"f32": ops}


def k10_reading(buf, img, dep, lut, reps=50):
    """K10 on `buf` (a [k, B] card tensor) against its plain version on
    the card: the depth bit for bit, the image within WIRE_DCT_TOL. Returns
    (largest image difference, CUDA-event ms, plain ms, bytes, ops)."""
    from orb_slam2_refactored_tpu_torch.ops import codec

    k_img, k_dep = codec.wire_unpack(buf, img, dep, lut)
    p_img, p_dep = codec.wire_unpack_plain(buf, img, dep)
    torch.cuda.synchronize()
    err = 0.0
    if dep is not None:
        assert torch.equal(k_dep, p_dep), "K10's depth is not the plain one"
    if img is not None:
        err = float((k_img - p_img).abs().max())
        assert err <= WIRE_DCT_TOL, f"K10's image {err} gray from plain"
    ms = cuda_time_ms(lambda: codec.wire_unpack(buf, img, dep, lut), reps)
    plain_ms = cuda_time_ms(lambda: codec.wire_unpack_plain(buf, img, dep),
                            max(reps // 5, 2))
    return (err, ms, plain_ms) + wire_work(buf, img, dep)


def einsum_ms(buf, img, reps=50):
    """K10's library call for the DCT half: the plain version's one
    `torch.einsum` on the decoded coefficients of `buf`'s rows."""
    from orb_slam2_refactored_tpu_torch.ops import codec

    _, H, W = img
    bh, bw, keep = H // 8, W // 8, codec.KEEP
    raw = buf[:, :codec.encoded_nbytes(H, W)].reshape(-1, bh, bw,
                                                      keep * keep)
    f = raw.to(torch.float32)
    K = (torch.where(raw < 128, f, f - 256.0) * codec.AC_STEP).reshape(
        -1, bh, bw, keep, keep).clone()
    K[..., 0, 0] = raw[..., 0].to(torch.float32) * codec.DC_STEP
    cr = torch.as_tensor(codec._dct_matrix()[:keep], device=buf.device)
    crt = cr.T.contiguous()
    return cuda_time_ms(
        lambda: torch.einsum("ak,rbwkl,lc->rbwac", crt, K, cr), reps)


def wire_batch(cfg, imgs, depths, k, device):
    """Cell A's first k frames packed under `cfg`, a [k, B] card tensor."""
    from orb_slam2_refactored_tpu_torch.slam.tracking import pack_rgbd

    return torch.from_numpy(np.stack([
        pack_rgbd(cfg, imgs[i], depths[i].astype(np.float32))
        for i in range(k)])).to(device)


def check_wire(imgs, depths, device):
    """K10 against its plain version: log8 bit for bit on all 256 codes and
    on cell A's frames at the bench's setting (one frame, a [4, B] batch);
    the DCT image within WIRE_DCT_TOL at WIRE_DCT_SIZES (cell A's frame 0
    tiled to the size) and on a [4, B] batch of DCT + log8 rows; a CPU
    tensor and a wrong dtype raise. Returns the readings of the bench's
    buffers ("log8", "log8_batch4") and of a DCT + log8 frame ("dct",
    "dct_batch4"), each (error, ms, plain ms, bytes, ops), and the
    einsum's ms on the DCT frame."""
    from orb_slam2_refactored_tpu_torch.ops import codec
    from orb_slam2_refactored_tpu_torch.slam import tracking

    lut = codec.log8_table(device)
    codes = torch.arange(256, dtype=torch.uint8, device=device)[None]
    assert torch.equal(codec.wire_unpack(codes, dep=(0, 16, 16), lut=lut)[1],
                       codec.decode_log8_plain(codes).reshape(1, 16, 16))
    out = {}
    for tag, kw in (("log8", {}), ("dct", {"image_encoding": "dct"})):
        cfg = ingest_config(**kw)
        img, dep = tracking.wire_sections(cfg)
        batch = wire_batch(cfg, imgs, depths, 4, device)
        out[tag] = k10_reading(batch[:1].contiguous(), img, dep, lut)
        out[tag + "_batch4"] = k10_reading(batch, img, dep, lut)
        if img is not None:
            lib = einsum_ms(batch[:1].contiguous(), img)
    sizes = {}
    for h, w in WIRE_DCT_SIZES:
        tiled = np.tile(imgs[0], (-(-h // 480), -(-w // 640)))[:h, :w]
        buf = torch.from_numpy(codec.encode_dct(tiled)).to(device)[None]
        r = k10_reading(buf, (0, h, w), None, lut, reps=20)
        b_ms, _ = bound_ms(r[3], r[4])
        sizes[f"{w}x{h}"] = {"max_abs_err": r[0], "ms": r[1],
                             "plain_ms": r[2], "bound_ms": b_ms}
    for bad, what in ((codes.cpu(), "a CPU tensor"),
                      (codes.to(torch.int32), "a wrong dtype")):
        try:
            codec.wire_unpack(bad, dep=(0, 16, 16), lut=lut)
        except ValueError:
            continue
        raise AssertionError(f"K10's wrapper took {what}")
    res = {t: {"max_abs_err": r[0], "ms": r[1], "plain_ms": r[2],
               "bound_ms": bound_ms(r[3], r[4])[0], "bytes": r[3]}
           for t, r in out.items()}
    print(f"K10 against its plain version ({card_line()}): " + json.dumps(
        {**res, "dct_sizes": sizes, "einsum_ms_dct": lib}))
    return out, lib


def wire_device_ms(wire, imgs, depths, device):
    """Phase 5: K10's device time (profiler rows) on each of `check_wire`'s
    buffers, appended to its reading."""
    from orb_slam2_refactored_tpu_torch.ops import codec
    from orb_slam2_refactored_tpu_torch.slam import tracking

    lut = codec.log8_table(device)
    for tag in list(wire):
        cfg = ingest_config(**({"image_encoding": "dct"}
                               if tag.startswith("dct") else {}))
        img, dep = tracking.wire_sections(cfg)
        buf = wire_batch(cfg, imgs, depths,
                         4 if tag.endswith("batch4") else 1, device)
        n_ops = []
        ms, rows = profiled_ms(
            lambda: codec.wire_unpack(buf, img, dep, lut), 20, n_ops)
        assert n_ops[0] == 1, rows
        wire[tag] = wire[tag][:5] + (ms,)
        print(f"K10 device time ({tag}) {ms:.5f} ms a call: {rows}")


# ---------------------------------------------------------------------------
# phase 3: the main paths
# ---------------------------------------------------------------------------

def check_fallback(imgs, depths, gt, device, n=12):
    """The step's other branch on the card: with `min_matches_mm` out of
    reach every tracked frame takes the reference-keyframe fallback
    (descriptor matching with K1 both ways, Horn RANSAC, LM). Returns the
    K1 and K4 calls of its last frame."""
    import dataclasses

    from orb_slam2_refactored_tpu_torch.io.evaluation import ate_rmse
    from orb_slam2_refactored_tpu_torch.slam.tracking import Tracker

    cfg = dataclasses.replace(bench_config(False), min_matches_mm=10 ** 6)
    tracker = Tracker(cfg, device=device)
    for i in range(n - 1):
        tracker.track_rgbd(imgs[i], depths[i].astype(np.float32))
    k1, k4 = [], []
    with recording_k1(k1), recording_k4(k4):
        tracker.track_rgbd(imgs[n - 1], depths[n - 1].astype(np.float32))
    info = tracker.track_info
    ate, _ = ate_rmse(np.stack(tracker.trajectory), gt[:n])
    n_ref = sum(1 for t in info if t.get("ref_fallback"))
    print(f"fallback branch: {n} frames, {n_ref} reference-KF steps, "
          f"ATE {ate:.4f} m")
    assert not any(t.get("lost") for t in info), "fallback branch lost a frame"
    assert n_ref == n - 1, f"{n_ref} of {n - 1} steps took the fallback"
    assert ate <= ATE_GATE_M
    return k1, k4


def record_tracked_frame(tracker, imgs, depths):
    """The K1, K2, K3, K4 and K9 calls of one more frame tracked after the
    main path (frame 0 again: the orbit closes), with the arguments they
    were given (K9's rank rounds the views of K2's buffers themselves)."""
    from orb_slam2_refactored_tpu_torch.ops import fast, orb

    k1, k2, k3, k4, k9 = [], [], [], [], []
    with recording_k1(k1), recording_k4(k4), \
            recording(k2, (fast, "detect_and_rank")), \
            recording(k3, (orb, "angles_and_descriptors_levels")), \
            recording(k9, (orb, "spread_topk_levels")):
        tracker.track_rgbd(imgs[0], depths[0].astype(np.float32))
    info = tracker.track_info[-1]
    assert not info.get("lost") and not info.get("ref_fallback"), info
    assert len(k2) == len(k3) == len(k9) == 1, (len(k2), len(k3), len(k9))
    return k1, k2[0], k3[0], k4, k9[0]


def record_tracked_stereo_frame(tracker, left, right):
    """The K1, K2, K3 and K4 calls of one more stereo frame tracked after
    cell C (frame 0 again: the orbit closes), its `stereo_associate`
    call (the stereo K1 call and B9) and its projection search (B6, K1,
    R), with their arguments."""
    from orb_slam2_refactored_tpu_torch.ops import fast, matching, orb, stereo
    from orb_slam2_refactored_tpu_torch.slam import tracking

    k1, k2, k3, k4, sad, sbp = [], [], [], [], [], []
    with recording_k1(k1), recording_k4(k4), \
            recording(k2, (fast, "detect_and_rank")), \
            recording(k3, (orb, "angles_and_descriptors_levels")), \
            recording(sad, (stereo, "stereo_associate"),
                      (tracking, "stereo_associate")), \
            recording(sbp, (matching, "search_by_projection_with_vis")):
        tracker.track_stereo(left[0], right[0])
    info = tracker.track_info[-1]
    assert not info.get("lost") and not info.get("ref_fallback"), info
    assert (len(k2), len(k3), len(sad), len(sbp)) == (2, 2, 1, 1), (
        len(k2), len(k3), len(sad), len(sbp))
    return k1, k4, sad[0], sbp[0]


def record_mapping(tracker, claims=None):
    """The arguments of one triangulation (its K1 calls with the epipolar
    pair gate) and of one window BA (its first `ba_assemble` call and its
    `ba_solve` call) around the newest keyframe, as the mapper makes them;
    kernel R's calls of that triangulation and of the fusion of the
    keyframe into its first two covisible ones go into `claims` if given.
    The mapper's products are discarded: the map is left as it was."""
    from orb_slam2_refactored_tpu_torch.ops import hamming
    from orb_slam2_refactored_tpu_torch.optim import ba
    from orb_slam2_refactored_tpu_torch.slam import local_mapping

    lm, kf = tracker.local_mapper, tracker.ref_kf
    saved = (lm._pending_tri, lm._pending_ba_erase, lm.n_ba)
    tri_k1, asm, solve = [], [], []
    with recording([] if claims is None else claims,
                   (hamming, "resolve_duplicates")):
        with recording_k1(tri_k1):
            lm.triangulate_new_points(tracker.map, tracker.graph, kf)
        for nb in tracker.graph.covis_neighbors(kf, top_k=2):
            lm._fuse_pair_impl(tracker.map, kf, nb)
    with recording(asm, (ba, "ba_assemble")), \
            recording(solve, (local_mapping, "ba_solve")):
        _, info = lm.local_ba(tracker.map, tracker.graph, kf)
    lm._pending_tri, lm._pending_ba_erase, lm.n_ba = saved
    assert info is not None and tri_k1 and asm and solve
    return tri_k1, asm[0], solve[0]


def timed_frame(timer, tracker, track):
    """One `track()` call timed as "step" by a synchronizing timer; True
    when a keyframe was made in it (an entry flagged `kf` appended: in
    pipelined mode the frame finalized in the call, not the one issued)."""
    n0 = len(tracker.track_info)
    with timer.time("step"):
        track()
    return any(t.get("kf") for t in tracker.track_info[n0:])


def step_stats(steps, kf_made, tracker, warmup=WARMUP_FRAMES):
    """The step's host times after `warmup` frames (median, p90, largest,
    fps), the host time of every frame that made a keyframe, the pumps that
    met a read not yet landed and the host's wait in the step's branch
    read (`use_ref.item()`) a tracked frame."""
    tracked = np.asarray(steps[warmup:])
    waits = np.asarray(tracker.use_ref_waits) * 1e3
    return {
        "step_ms_median": float(np.median(tracked) * 1e3),
        "step_ms_p90": float(np.percentile(tracked, 90) * 1e3),
        "step_ms_max": float(tracked.max() * 1e3),
        "fps_after_warmup": float(len(tracked) / tracked.sum()),
        "kf_frame_ms": [s * 1e3 for s, k in zip(steps, kf_made) if k],
        "pumps_not_ready": tracker.pumps_not_ready,
        "use_ref_wait_ms_median": float(np.median(waits)),
        "use_ref_wait_ms_mean": float(waits.mean()),
    }


def stage_clock(tracker):
    """How the tracker's `kf.*` stage timer reads the clock."""
    return ("host clock, synchronized" if tracker.timer.sync
            else "host clock only")


def pipelined(cfg, depth):
    """`cfg` in pipelined mode at `depth` frames in flight (0: as it is,
    synchronous)."""
    import dataclasses

    if not depth:
        return cfg
    return dataclasses.replace(cfg, pipelined=True, pipeline_depth=depth)


def viewer_readings(viewer, ticks, spans, step_s, warmup=WARMUP_FRAMES):
    """A `LiveViewer`'s readings over a tracked run: the `ticks` rendered
    while tracking and their host ms, and the step's host ms after
    `warmup` frames split into the frames whose span (`spans`, on
    `time.perf_counter`'s clock) overlapped a rendered tick and the
    others: count, median and p90 of each."""
    v_ms = np.asarray(viewer.render_ms[:ticks] or [np.nan])
    rendered = [(a, b) for a, b, r in viewer.tick_spans if r]
    over = np.asarray([any(a < f1 and f0 < b for a, b in rendered)
                       for f0, f1 in spans[warmup:]], bool)
    steps = np.asarray(step_s[warmup:]) * 1e3
    out = {"ticks_rendered": ticks,
           "render_ms_median": float(np.median(v_ms)),
           "render_ms_max": float(v_ms.max()),
           "reads_not_landed": viewer.reads_not_landed,
           "failed_ticks": viewer.failures}
    for tag, sel in (("overlapping", over), ("apart", ~over)):
        x = steps[sel]
        out[f"frames_{tag}"] = int(sel.sum())
        out[f"step_ms_median_{tag}"] = (float(np.median(x)) if x.size
                                        else None)
        out[f"step_ms_p90_{tag}"] = (float(np.percentile(x, 90)) if x.size
                                     else None)
    return out


def run_main_path(imgs, second, gt, device, local_ba, stereo=False,
                  label=None, depth=0, viewer_dir=None, viewer_hz=None):
    """One cell: `imgs` with their depth maps (`second`) through
    `track_rgbd`, or, with `stereo`, left images with the right ones
    through `track_stereo`; `label` is added to the printed tag; `depth`
    > 0 runs it pipelined with that many frames in flight. With
    `viewer_dir`, a `LiveViewer` at `viewer_hz` (VIEWER_HZ by default)
    renders the tracker there while it tracks (phase 3o), stopped after
    the flush; its readings (`viewer_readings`) are `stats["viewer"]`."""
    from orb_slam2_refactored_tpu_torch import kernels
    from orb_slam2_refactored_tpu_torch.io.evaluation import ate_rmse, rpe
    from orb_slam2_refactored_tpu_torch.slam.tracking import Tracker
    from orb_slam2_refactored_tpu_torch.utils.timing import StageTimer

    tag = "local BA on" if local_ba else "local BA off"
    if stereo:
        tag = "stereo, " + tag
    if label:
        tag += ", " + label
    if depth:
        tag += f", pipelined depth {depth}"
    tracker = Tracker(pipelined(bench_config(local_ba), depth), device=device)
    timer = StageTimer(device)  # synchronizes the card at both ends
    viewer = None
    if viewer_dir is not None:
        from orb_slam2_refactored_tpu_torch.viz.viewer import LiveViewer

        viewer = LiveViewer(tracker, out_dir=viewer_dir,
                            hz=viewer_hz or VIEWER_HZ).start()
    kernels.reset_counts()
    kf_made, spans = [], []
    for i in range(len(imgs)):
        if stereo:
            track = partial(tracker.track_stereo, imgs[i], second[i],
                            timestamp=i / 30.0)
        else:
            track = partial(tracker.track_rgbd, imgs[i],
                            second[i].astype(np.float32), timestamp=i / 30.0)
        t0 = time.perf_counter()
        kf_made.append(timed_frame(timer, tracker, track))
        spans.append((t0, time.perf_counter()))
    tracker.flush()
    launches = kernels.counts()
    step_s = timer.samples["step"]
    if viewer is not None:
        ticks = viewer.frames_rendered
        viewer.stop()  # and a last render, waited for
        viewer = viewer_readings(viewer, ticks, spans, step_s)
    est = np.stack(tracker.trajectory)
    assert est.shape == gt.shape and np.isfinite(est).all()
    ate, _ = ate_rmse(est, gt, align="se3")
    t_rpe, r_rpe = rpe(est, gt)
    lost = sum(1 for t in tracker.track_info if t.get("lost"))
    fallbacks = sum(1 for t in tracker.track_info if t.get("ref_fallback"))
    created = 1 + sum(1 for t in tracker.track_info if t.get("kf"))
    n_ba = tracker.local_mapper.n_ba if local_ba else 0
    stats = {
        "path": tag, "frames": len(imgs), "ate_m": ate, "rpe_m": t_rpe,
        "rpe_rad": r_rpe, "keyframes_created": created,
        "keyframes_alive": len(tracker.graph.alive_kfs()),
        "lost_frames": lost, "ref_fallbacks": fallbacks,
        "window_ba_solves": n_ba,
        "map_points_alive": int(tracker.graph.pt_alive.sum()),
        **step_stats(step_s, kf_made, tracker),
        "first_frame_ms": step_s[0] * 1e3,
        "launches": launches,
    }
    if viewer is not None:
        stats["viewer"] = viewer
    print(f"main path ({tag}) " + json.dumps(stats))
    if local_ba:
        print(f"keyframe stages ({stage_clock(tracker)}):")
        for line in tracker.timer.report().splitlines():
            print("  " + line)
    assert ate <= ATE_GATE_M, f"ATE {ate} m above the {ATE_GATE_M} m gate"
    assert lost == 0, f"{lost} frames lost"
    for k, v in launches.items():
        if k == LARGE_KERNEL or off_cell(k, v, tag):
            continue  # `extraction_launches` holds K9's large kernel
        if k == LEARNED_KERNEL:
            assert v == 0, f"K7 launched on the fresh pattern's path ({tag})"
        elif k == "stereo_sad" and not stereo:
            assert v == 0, f"B9 launched on the RGB-D path ({tag})"
        elif k in LOOP_KERNELS:
            assert v == 0, f"{k} launched with loop closing off ({tag})"
        elif local_ba or not k.startswith("ba_"):
            assert v > 0, f"kernel {k} never launched on the path ({tag})"
    # one extraction call of each a frame, two a stereo frame and one B9
    per_frame = 2 if stereo else 1
    for k in ("fast", "orb_desc"):
        assert launches[k] == per_frame * len(imgs), (k, launches[k],
                                                      len(imgs))
    extraction_launches(launches, per_frame * len(imgs), tag)
    if stereo:
        assert launches["stereo_sad"] == len(imgs), launches
    if local_ba:
        assert n_ba >= created - 2 >= 1, (n_ba, created)
        # K5: one point index (two launches) a solve, one launch a call of
        # `ba_assemble` and of `ba_cost`
        it = tracker.cfg.local_ba_iters
        assert (launches["ba_point_index"], launches["ba_assemble"],
                launches["ba_cost"]) == (2 * n_ba, it * n_ba,
                                         (it + 2) * n_ba), launches
    return stats, tracker


def kidnap_config():
    """Cell D's configuration: the bench's RGB-D one with a keyframe at least
    every 8 frames (`tests/test_kidnap_reloc.py:70`)."""
    import dataclasses

    return dataclasses.replace(bench_config(True), kf_max_interval=8)


def snapshot_db(db):
    """A copy of a KeyFrameDatabase whose rows, idf and active mask later
    keyframes cannot change."""
    import copy

    snap = copy.copy(db)
    snap.bow_ids, snap.bow_cnt = db.bow_ids.clone(), db.bow_cnt.clone()
    snap.idf, snap.active = db.idf.clone(), db.active.copy()
    return snap


def record_relocalization(tracker, relocalize, frame):
    """Run a successful relocalization (`relocalize`, the tracker's own
    `_relocalize`) once more on the same frame, map, database and frame id,
    which repeats it call for call (its generators are seeded from the frame
    id), with its K1, K4, RANSAC and projection-search calls and its
    stages' arguments recorded; the launch counters are left as they were.
    Returns those with copies of the frame, the map and the database."""
    from orb_slam2_refactored_tpu_torch import kernels
    from orb_slam2_refactored_tpu_torch.ops import matching
    from orb_slam2_refactored_tpu_torch.slam import tracking

    saved = kernels.counts()
    rec = {"frame": _clone(frame), "frame_id": tracker.frame_id,
           "map": _clone(tracker.map),
           "db": snapshot_db(tracker.loop_closer.db)}
    k1, k4, ransac, match, solve, polish = [], [], [], [], [], []
    sbp = []
    with recording_k1(k1), recording_k4(k4), \
            recording(ransac, (tracking, "horn_ransac")), \
            recording(sbp, (matching, "search_by_projection_with_vis")), \
            recording(match, (tracker, "_reloc_match_impl")), \
            recording(solve, (tracker, "_reloc_solve_impl")), \
            recording(polish, (tracker, "_reloc_polish_impl")):
        ok = relocalize(frame)
    kernels.LAUNCHES.update(saved)
    assert ok, "the replayed relocalization failed"
    rec.update(k1=k1, k4=k4, ransac=ransac, match=match, solve=solve,
               polish=polish, sbp=sbp)
    return rec


def run_kidnap(imgs, depths, gt, device, cfg=None):
    """Cell D (kidnap, RGB-D, local BA on), a tracker of its own on cell
    A's frames: frames 0 to KIDNAP_MAP - 1 mapped, KIDNAP_BLANK all-zero
    image and depth frames, then a resume at KIDNAP_RESUME's views (mapped
    in the first phase). Asserts LOST through the blackout with more than 5
    alive keyframes (no auto-reset), the vocabulary trained at the 4th
    keyframe and every keyframe indexed, and a relocalization within
    RELOC_MAX_FRAMES resume frames, the last frame OK and the
    post-recovery ATE <= RELOC_ATE_M. Every `_relocalize` call is timed on a
    synchronizing host clock; the first success is replayed with its
    arguments recorded (`record_relocalization`)."""
    from orb_slam2_refactored_tpu_torch import kernels
    from orb_slam2_refactored_tpu_torch.io.evaluation import ate_rmse
    from orb_slam2_refactored_tpu_torch.slam import tracking
    from orb_slam2_refactored_tpu_torch.slam.tracking import (
        Tracker, TrackState)

    tracker = Tracker(cfg or kidnap_config(), device=device)
    train_log, reloc_ms, rec = [], [], {}
    real_train, real_reloc = tracking.train_vocabulary, tracker._relocalize

    def train(descriptors, **kw):
        train_log.append({"keyframes_created": tracker.graph.num_kfs,
                          "descriptors": descriptors, **kw})
        return real_train(descriptors, **kw)

    def relocalize(frame):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = real_reloc(frame)
        torch.cuda.synchronize()
        reloc_ms.append((time.perf_counter() - t0) * 1e3)
        if ok and not rec:
            rec.update(record_relocalization(tracker, real_reloc, frame),
                       host_ms=reloc_ms[-1])
        return ok

    tracking.train_vocabulary = train
    tracker._relocalize = relocalize
    blank = np.zeros_like(imgs[0])
    blank_depth = np.zeros(depths[0].shape, np.float32)
    states = {"blank": [], "resume": []}
    kernels.reset_counts()
    try:
        for i in range(KIDNAP_MAP):
            tracker.track_rgbd(imgs[i], depths[i].astype(np.float32),
                               timestamp=i / 30.0)
        n_kf = len(tracker.graph.alive_kfs())
        for j in range(KIDNAP_BLANK):
            tracker.track_rgbd(blank, blank_depth,
                               timestamp=(KIDNAP_MAP + j) / 30.0)
            states["blank"].append(int(tracker.state))
        n_kf_blank = len(tracker.graph.alive_kfs())
        for k, i in enumerate(KIDNAP_RESUME):
            tracker.track_rgbd(imgs[i], depths[i].astype(np.float32),
                               timestamp=(KIDNAP_MAP + KIDNAP_BLANK + k) / 30.0)
            states["resume"].append(int(tracker.state))
        launches = kernels.counts()
    finally:
        tracking.train_vocabulary = real_train
    lc, g = tracker.loop_closer, tracker.graph
    alive = g.alive_kfs()
    resume = states["resume"]
    first_ok = (resume.index(TrackState.OK) if TrackState.OK in resume
                else len(resume))
    n = len(KIDNAP_RESUME)
    ate = float("nan")
    if first_ok < n:
        est = np.stack(tracker.trajectory[-(n - first_ok):])
        ate, _ = ate_rmse(est, gt[KIDNAP_RESUME.start + first_ok:
                                  KIDNAP_RESUME.stop], align="se3")
    loop_ms = [s * 1e3 for s in tracker.timer.samples["kf.loop"]]
    stats = {
        "path": "kidnap (cell D)", "keyframes_alive_before_blackout": n_kf,
        "keyframes_alive_after_blackout": n_kf_blank,
        "keyframes_created": g.num_kfs, "keyframes_alive": len(alive),
        "blank_states": states["blank"],
        "vocabulary_trained_at_keyframe": [t["keyframes_created"]
                                           for t in train_log],
        "training_descriptors": [len(t["descriptors"]) for t in train_log],
        "keyframes_indexed": None if lc is None else lc._n_indexed,
        "recovered_at_resume_frame": first_ok,
        "recovered_at_view": KIDNAP_RESUME.start + first_ok,
        "post_recovery_ate_m": ate,
        "relocalize_host_ms": reloc_ms,
        "kf_loop_ms": loop_ms,
        "launches": launches,
    }
    print("main path (kidnap, cell D) " + json.dumps(stats))
    print(f"cell D: relocalized at resume frame {first_ok} (view "
          f"{KIDNAP_RESUME.start + first_ok}), post-recovery ATE {ate:.6f} m")
    assert n_kf > 5, n_kf
    assert all(s == TrackState.LOST for s in states["blank"]), states
    assert n_kf_blank == n_kf, "the blackout reset the map"
    assert [t["keyframes_created"] for t in train_log] == \
        [tracker.VOCAB_TRAIN_KFS], train_log
    assert lc is not None and lc.db.active[alive].all()
    assert len(loop_ms) == g.num_kfs, (len(loop_ms), g.num_kfs)
    extraction_launches(launches, KIDNAP_MAP + KIDNAP_BLANK
                        + len(KIDNAP_RESUME), "cell D")
    assert first_ok <= RELOC_MAX_FRAMES, resume
    assert resume[-1] == TrackState.OK, resume
    assert ate <= RELOC_ATE_M, ate
    assert rec, "no relocalization was recorded"
    for k, v in launches.items():
        if k == LARGE_KERNEL or off_cell(k, v, "cell D"):
            continue  # `extraction_launches` holds K9's large kernel
        if k in ("stereo_sad", LEARNED_KERNEL) or k in LOOP_KERNELS:
            assert v == 0, f"{k} launched on cell D"
        else:
            assert v > 0, f"kernel {k} never launched on cell D"
    rec["train"] = train_log[0]
    return stats, tracker, rec


def check_stereo_save_load(tracker_c, left, right, gt, device):
    """Cell C's map through `save_map`, `load_map` into a fresh stereo
    tracker (LOST), then the pairs from RELOAD_VIEW on: it must relocalize
    within 3 pairs, to within 2 cm (camera centre) of cell C's tracked pose
    at that frame in the saved map: the pose relative to its reference
    keyframe that the tracker recorded at the frame (Tcr), composed with
    that keyframe's pose in the saved map, as ORB-SLAM's trajectory output
    reads it. The track-time pose (before the later window BAs moved the
    map) and the ground truth (after cell C's SE3 alignment) are printed
    beside it. Launch counters set to 0 before the tracking, read after."""
    import os

    from orb_slam2_refactored_tpu_torch import kernels
    from orb_slam2_refactored_tpu_torch.geometry import se3
    from orb_slam2_refactored_tpu_torch.io.evaluation import (
        _positions, umeyama_alignment)
    from orb_slam2_refactored_tpu_torch.slam.serialize import (
        load_map, save_map)
    from orb_slam2_refactored_tpu_torch.slam.tracking import (
        Tracker, TrackState)

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "cell_c_map.npz")
    t0 = time.perf_counter()
    save_map(tracker_c, path)
    t1 = time.perf_counter()
    t2 = load_map(Tracker(bench_config(True), device=device), path)
    t_load = time.perf_counter() - t1
    assert t2.state == TrackState.LOST and t2.loop_closer is not None
    kernels.reset_counts()
    states = []
    for i in range(RELOAD_VIEW, RELOAD_VIEW + 3):
        t2.track_stereo(left[i], right[i])
        states.append(int(t2.state))
        if t2.state == TrackState.OK:
            break
    launches = kernels.counts()

    def t32(p):
        return torch.tensor(np.asarray(p, np.float32))

    def gaps(ref):
        """(camera-centre distance m, rotation rad) of the relocalized pose
        from `ref`."""
        d = se3.log(se3.compose(t32(t2.pose), se3.inverse(t32(ref))))
        c = se3.inverse(t32(t2.pose))[4:] - se3.inverse(t32(ref))[4:]
        return float(c.norm()), float(d[:3].norm())

    entry = tracker_c.traj_entries[i]
    assert tracker_c.graph.kf_alive[entry["ref"]], entry["ref"]
    in_map = se3.compose(t32(entry["tcr"]),
                         tracker_c.map.kf_pose[entry["ref"]].cpu())
    gap, rot = gaps(in_map)
    # the relocalized camera centre against the ground truth, in cell C's
    # SE3 alignment of its whole trajectory
    _, R, t = umeyama_alignment(_positions(np.stack(tracker_c.trajectory[
        :len(gt)])), _positions(gt))
    c_gt = float(np.linalg.norm(R @ _positions(np.asarray(t2.pose)[None])[0]
                                + t - _positions(gt[i:i + 1])[0]))
    res = {"file_mb": os.path.getsize(path) / 2 ** 20,
           "save_s": t1 - t0, "load_s": t_load, "states": states,
           "relocalized_at_pair": i, "reference_keyframe": int(entry["ref"]),
           "centre_gap_m": gap, "rotation_gap_rad": rot,
           "track_time_gap_m_rad": gaps(tracker_c.trajectory[i]),
           "centre_vs_ground_truth_m": c_gt, "launches": launches}
    print("stereo save/load " + json.dumps(res))
    assert states[-1] == TrackState.OK, states
    assert gap <= 0.02, gap
    for k in ("hamming_best2", "pose_lm", "fast", "orb_desc", "stereo_sad"):
        assert launches[k] > 0, (k, launches)
    extraction_launches(launches, 2 * len(states), "stereo save/load")
    return res


def _profile_window(tracker, track, frames, tag):
    """Track `frames` (`track(k)` tracks frame k) under torch.profiler: the
    device's busy share, time and kernel launches a frame, and the kernels
    that take its time."""
    from torch.profiler import ProfilerActivity, profile

    kf_before = sum(1 for t in tracker.track_info if t.get("kf"))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in frames:
            track(k)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kf_in = sum(1 for t in tracker.track_info if t.get("kf")) - kf_before
    # device-side rows only: the aten rows repeat their kernels' time
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    dev_us = sum(e.self_device_time_total for e in rows)
    m = len(frames)
    out = {
        "window": tag, "profiled_frames": m, "keyframes_in_window": kf_in,
        "device_busy_share": dev_us / (wall * 1e6),
        "device_ms_per_frame": dev_us / 1e3 / m,
        "wall_ms_per_frame": wall * 1e3 / m,
        "device_ops_per_frame": sum(e.count for e in rows) / m,
        "copies_to_host_per_frame": sum(e.count for e in rows
                                        if "DtoH" in e.key) / m,
        "uploads_per_frame": sum(e.count for e in rows
                                 if "HtoD" in e.key) / m,
    }
    print("profile " + json.dumps(out))
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / 1e3 / m:8.3f} ms/frame "
              f"{e.count / m:7.1f} calls/frame  {e.key[:90]}")


def profile_steps(tracker, imgs, depths, n_split=10, n_prof=20, n_kf=3):
    """Where a frame's time goes, after the main path: extraction
    (`_prepare_impl`) against the whole step on a synchronizing host clock;
    a torch.profiler window over tracked frames; then one over frames that
    each make a keyframe (`kf_max_interval` set to 1 for the window), so
    that the mapping job and its window BA are in it."""
    def track(k):
        tracker.track_rgbd(imgs[k % n], depths[k % n].astype(np.float32))

    dev = tracker.device
    n = len(imgs)
    prep, step = [], []
    for k in range(1, n_split + 1):
        i = k % n  # the orbit closes: frame 0 follows frame n-1
        img_t = torch.as_tensor(imgs[i], device=dev)
        dep_t = torch.as_tensor(depths[i].astype(np.float32), device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tracker._prepare_impl(img_t, dep_t)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tracker.track_rgbd(imgs[i], depths[i].astype(np.float32))
        torch.cuda.synchronize()
        prep.append(t1 - t0)
        step.append(time.perf_counter() - t1)
    print("split " + json.dumps({
        "extract_ms_median": float(np.median(prep) * 1e3),
        "step_ms_median": float(np.median(step) * 1e3)}))
    first = n_split + 1
    _profile_window(tracker, track, range(first, first + n_prof),
                    "tracked frames")
    first += n_prof
    keep = tracker.cfg.kf_max_interval
    tracker.cfg.kf_max_interval = 1
    try:
        _profile_window(tracker, track, range(first, first + n_kf),
                        "keyframe frames (mapping job and window BA)")
    finally:
        tracker.cfg.kf_max_interval = keep


def compare_extraction(imgs, device, n=20):
    """Extraction in four variants on the same `n` frames: "plain" (the
    rank rounds through the plain `cell_rank_rounds` on the card, K2 then
    giving the score planes only, with the plain pyramid and top-k),
    "fused" (the rank rounds in K2, the plain pyramid and top-k: the
    extraction before K8 and K9), "kernels" (K8, K2, K9 and K3: four
    launches) and "learned" (the learned pattern's path: K8, K2, K9 and
    K7, an extractor of its own). Host clock around synchronized frames in
    turns (each variant, then each again in reverse order), then one
    torch.profiler window of each for the device time, the device
    operations and the pageable uploads a frame. "plain" and "fused" must
    select the same features; "kernels" must too on every frame whose K8
    pyramid equals the plain one bit for bit (the others are counted);
    "learned" must select the features "kernels" selects, and build no
    K7 table on a frame."""
    from torch.profiler import ProfilerActivity, profile

    from orb_slam2_refactored_tpu_torch.ops import fast, orb
    from orb_slam2_refactored_tpu_torch.ops import image as image_ops

    ext = orb.OrbExtractor(480, 640, 1000, 1.2, 8, device=device)
    ext_learned = orb.OrbExtractor(480, 640, 1000, 1.2, 8, pattern="learned",
                                   device=device)
    frames = [torch.as_tensor(imgs[i], device=device) for i in range(n)]
    fused = fast.detect_and_rank
    kernels_path = (image_ops.build_pyramid, orb.spread_topk_levels)
    plain_path = (image_ops.build_pyramid_plain, orb.spread_topk_levels_plain)

    def plain_ranking(levels, ini_th, min_th, ks, cell=30, margin=0,
                      rank_cell=32, rank_rounds=4):
        outs = fused(levels, ini_th, min_th, [0] * len(levels), cell, margin,
                     rank_cell, rank_rounds)
        return fast.RankRounds(
            [(s,) + fast.cell_rank_rounds(s, k, rank_cell, rank_rounds)
             for (s, _, _), k in zip(outs, ks)])

    def run(variant):
        fast.detect_and_rank = plain_ranking if variant == "plain" else fused
        image_ops.build_pyramid, orb.spread_topk_levels = (
            kernels_path if variant in ("kernels", "learned") else plain_path)
        e = ext_learned if variant == "learned" else ext
        try:
            out = [e(f) for f in frames]
            torch.cuda.synchronize()
        finally:
            fast.detect_and_rank = fused
            image_ops.build_pyramid, orb.spread_topk_levels = kernels_path
        return out

    variants = ("plain", "fused", "kernels", "learned")
    builds = [0]
    with counting_plan_builds(builds):
        feats = {v: run(v) for v in variants}  # warm-up
    assert builds[0] == 0, "an extractor built a table on a frame"
    for a, b in zip(feats["learned"], feats["kernels"]):
        assert all(torch.equal(getattr(a, f), getattr(b, f)) for f in
                   ("xy", "level", "response", "valid")), \
            "the learned path selects other features"
    for a, b in zip(feats["plain"], feats["fused"]):
        assert all(torch.equal(x, y) for x, y in zip(a, b)), \
            "the fused ranking selects other features"
    pyr_equal, same = 0, 0
    for f, a, b in zip(frames, feats["kernels"], feats["fused"]):
        g = image_ops.to_gray(f)
        eq = all(torch.equal(x, y) for x, y in zip(
            image_ops.build_pyramid(g, 8, 1.2),
            image_ops.build_pyramid_plain(g, 8, 1.2)))
        s = all(torch.equal(x, y) for x, y in zip(a, b))
        assert s or not eq, "K8 and K9 select other features on equal levels"
        pyr_equal += eq
        same += s
    wall = {v: [] for v in variants}
    for v in variants + variants[::-1]:
        t0 = time.perf_counter()
        run(v)
        wall[v].append((time.perf_counter() - t0) * 1e3 / n)
    res = {"frames": n, "frames_k8_bit_equal": pyr_equal,
           "frames_kernels_same_features": same}
    for v in variants:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(GUARD_S)  # `profiled_ms`: margins keep every launch
            t0 = time.perf_counter()
            run(v)
            prof_wall = time.perf_counter() - t0
            time.sleep(GUARD_S)
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
        res[v] = {
            "extract_ms": wall[v],
            "device_ms_per_frame": sum(e.self_device_time_total
                                       for e in rows) / 1e3 / n,
            "device_ops_per_frame": sum(e.count for e in rows) / n,
            "uploads_per_frame": sum(e.count for e in rows
                                     if "HtoD" in e.key) / n,
            "profiled_wall_ms_per_frame": prof_wall * 1e3 / n,
        }
        print(f"  extraction, {v}, top device rows a frame:")
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"    {e.self_device_time_total / 1e3 / n:8.4f} ms "
                  f"{e.count / n:6.1f} calls  {e.key[:70]}")
    print("extraction " + json.dumps(res))
    for v in ("kernels", "learned"):
        k = res[v]
        assert k["device_ops_per_frame"] <= 10, (v, k)
        assert k["uploads_per_frame"] == 0, (v, k)
    return res


def device_times_k1(calls, reps=20):
    """K1's device time on the recorded tracked frame: each call alone, then
    the frame's calls together (the row's `device_ms`)."""
    from orb_slam2_refactored_tpu_torch.ops import hamming

    for name, a in calls.items():
        ms, rows = profiled_ms(lambda: hamming.masked_best2_gated(**a), reps)
        print(f"K1 device time {name}: {ms:.5f} ms a call: {rows}")
    ms, rows = profiled_ms(lambda: [hamming.masked_best2_gated(**a)
                                    for a in calls.values()], reps)
    print(f"K1 device time, the frame's {len(calls)} calls: {ms:.5f} ms: "
          f"{rows}")
    return ms


def device_times_k4(calls, reps=20):
    """K4's device time on the recorded tracked frame's calls."""
    from orb_slam2_refactored_tpu_torch.optim import pose_opt

    for name, a in calls.items():
        ms, rows = profiled_ms(lambda: pose_opt.pose_optimize(**a), reps)
        print(f"K4 device time {name}: {ms:.5f} ms a call: {rows}")
    ms, rows = profiled_ms(lambda: [pose_opt.pose_optimize(**a)
                                    for a in calls.values()], reps)
    print(f"K4 device time, the frame's {len(calls)} calls: {ms:.5f} ms: "
          f"{rows}")
    return ms


def k4_iteration_ms(fn, device, reps=20):
    """Device time of one LM iteration of the pose-LM function `fn` on no
    observation at all: a reduction of zeros, the 6x6 solve of a zero
    system, the retraction and the accept rules. With H = 0 every step is
    refused, and lambda climbs from 1e-3 past 1e6 in 16 iterations, so 4
    rounds of 16 run 64 iterations."""
    from orb_slam2_refactored_tpu_torch.optim import pose_opt

    z = torch.zeros((0,), dtype=torch.float32, device=device)
    a = dict(pose0=torch.tensor([1.0, 0, 0, 0, 0, 0, 0], device=device),
             pts_w=z.reshape(0, 3), obs_uv=z.reshape(0, 2), obs_ur=z,
             inv_sigma2=z, valid=torch.zeros((0,), dtype=torch.bool,
                                             device=device),
             cam=bench_cam(), rounds=4, iters_per_round=16)
    iters = int(pose_opt.pose_lm_work(**a)[:, 0].sum())
    ms, _ = profiled_ms(lambda: fn(**a), reps)
    return ms / iters


def k4_chain(calls, device, reps=20):
    """Where K4's time goes on the recorded calls: the same calls with no
    LM iteration (each round's fused reclassification pass and reduction,
    and the final pass) against the full calls give the time of a pass
    and of an iteration (a pass at the candidate, its reduction, and warp
    0's accept rules, solve and broadcast). Also one iteration on no
    observation (`k4_iteration_ms`)."""
    from orb_slam2_refactored_tpu_torch.optim import pose_opt

    iters = sum(int(pose_opt.pose_lm_work(**a)[:, 0].sum())
                for a in calls.values())
    passes = sum(a["rounds"] + 1 for a in calls.values())
    full, _ = profiled_ms(lambda: [pose_opt.pose_optimize(**a)
                                   for a in calls.values()], reps)
    bare, _ = profiled_ms(lambda: [pose_opt.pose_optimize(
        **{**a, "iters_per_round": 0}) for a in calls.values()], reps)
    per_pass, per_iter = bare / passes, (full - bare) / iters
    empty = k4_iteration_ms(pose_opt.pose_optimize, device, reps)
    print(f"K4 on the recorded frame: {full:.5f} ms for {iters} iterations "
          f"and {passes} passes; without iterations {bare:.5f} ms, so "
          f"{per_pass * 1e3:.3f} us a pass and {per_iter * 1e3:.3f} us an "
          f"iteration; on no observation {empty * 1e3:.3f} us an "
          f"iteration")
    return {"iterations": iters, "passes": passes, "pass_us": per_pass * 1e3,
            "iteration_us": per_iter * 1e3, "empty_iteration_us": empty * 1e3}


def device_times_k5(asm_call, index_r, asm_r, cost_r, reps=20):
    """K5's device time on the recorded window BA's first LM iteration:
    each entry as the solve calls it, its kernels' launches alone (no fill
    and no torch sum beside them); `ba_cost` also without chi2, as
    the solve's LM steps call it."""
    from orb_slam2_refactored_tpu_torch.optim import ba

    a = asm_call
    c = {n: v for n, v in a.items() if n not in ("index", "w_obs")}
    p, Q = a["p"], a["p"].pt_pos.shape[0]
    out = []
    for name, fn, r, launches in (
            ("ba_point_index",
             lambda: ba.ba_point_index(p.obs_pt, a["obs_ok"], Q), index_r, 2),
            ("ba_assemble", lambda: ba.ba_assemble(**a), asm_r, 1),
            ("ba_cost", lambda: ba.ba_cost(**c), cost_r, 1)):
        ops = []
        ms, rows = profiled_ms(fn, reps, ops)
        print(f"K5 device time {name}: {ms:.5f} ms a call, {ops[0]:g} device "
              f"operations: {rows}")
        assert ops[0] == launches, (name, rows)
        out.append(r + (ms,))
    ms, rows = profiled_ms(lambda: ba.ba_cost(**c, want_chi2=False), reps)
    print(f"K5 device time ba_cost without chi2: {ms:.5f} ms a call: {rows}")
    return out


# ---------------------------------------------------------------------------
# --parent: K1, K4, K5, B9, K6, K8, K9 and K7 against the parent's kernels
# ---------------------------------------------------------------------------

def build_parent(parent):
    """The port package of another checkout (`parent`), imported from it as
    the package `parent_port` with its kernels built from its own sources
    (all at once, into its own `build/torch_kernels/`); its wrappers bind
    each kernel with its own C signature. Returns its entries by job
    (`SIDE_JOBS`): K1, K4, K5 (assembly, cost), B9
    (`associate_from_best2`), K6 (`ba_schur_cg`, with `cg_args` to hand it
    a recorded call: W_obs in the parent's own `LiveRows` type), the
    global BA (`ba_solve`), K8 (`build_pyramid`), K9
    (`spread_topk_levels`), K7 (`angles_and_descriptors_learned_levels`,
    which builds its C arguments its own way) and the projection search
    (`search_by_projection_with_vis`)."""
    import importlib
    import importlib.util
    import os

    pkg = os.path.join(parent, "orb_slam2_refactored_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "parent_port", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    sys.modules["parent_port"] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sys.modules["parent_port"])
    t0 = time.perf_counter()
    importlib.import_module("parent_port.kernels").build_all()
    print(f"the parent's kernels built in {time.perf_counter() - t0:.1f} s")
    old_hamming = importlib.import_module("parent_port.ops.hamming")
    old_pose = importlib.import_module("parent_port.optim.pose_opt")
    old_ba = importlib.import_module("parent_port.optim.ba")
    old_stereo = importlib.import_module("parent_port.ops.stereo")
    old_image = importlib.import_module("parent_port.ops.image")
    old_orb = importlib.import_module("parent_port.ops.orb")
    old_matching = importlib.import_module("parent_port.ops.matching")

    def cg_args(c):
        live = c["W_obs"]
        return {**c, "W_obs": old_ba.LiveRows(
            live.rows, old_ba.PointIndex(*live.index))}

    return {"k1": old_hamming.masked_best2_gated,
            "k4": old_pose.pose_optimize, "asm": old_ba.ba_assemble,
            "cost": old_ba.ba_cost, "b9": old_stereo.associate_from_best2,
            "cg": old_ba.ba_schur_cg, "cg_args": cg_args,
            "solve": old_ba.ba_solve, "k8": old_image.build_pyramid,
            "k9": old_orb.spread_topk_levels,
            "k7": old_orb.angles_and_descriptors_learned_levels,
            "sbp": old_matching.search_by_projection_with_vis,
            "b6": old_matching.project_candidates,
            "r": partial(r_side, old=old_hamming),
            "mm": partial(mm_side, old=old_matching)}


def r_side(old=None, **c):
    """One of the tracked frame's R calls (recorded, `r_entry`) through
    this checkout's R (`old` None) or the parent's `ops/hamming.py`
    (`old`): the motion-model call is the rows mode here and the parent's
    `resolve_duplicates` over `parent_valid` (valid & dist <= max_dist,
    computed once beforehand: one launch on each side); the projection
    call is `resolve_to_points` on both."""
    parent_valid = c.pop("parent_valid", None)
    if old is None or "slot" in c:
        return (r_entry(c) if old is None else old.resolve_to_points)(**c)
    return old.resolve_duplicates(c["target_idx"], c["dist"], parent_valid,
                                  c["n_targets"])


def mm_side(old=None, **a):
    """A recorded `search_last_frame_mapped` call through this checkout
    (`old` None) or as the parent's tracker made it (`old`: the parent's
    `ops/matching.py`): the gather of the last frame's map points in torch,
    then its `search_last_frame`."""
    if old is None:
        from orb_slam2_refactored_tpu_torch.ops import matching

        return matching.search_last_frame_mapped(**a)
    lm_idx = torch.clamp(a["last_mp"], 0, a["mp_pos"].shape[0] - 1).long()
    lm_ok = (a["last_mp"] >= 0) & a["mp_valid"][lm_idx]
    return old.search_last_frame(
        a["curr_xy"], a["curr_level"], a["curr_desc"], a["curr_valid"],
        None, a["last_level"], a["last_desc"], lm_ok, lm_ok,
        a["mp_pos"][lm_idx], a["pose_cw"], a["cam"], a["scale_factors"],
        **{k: a[k] for k in ("radius", "max_dist") if k in a})


def in_turns(label, calls, fns, reps=20):
    """CUDA-event time over `reps` runs of the recorded `calls` through
    each of `fns` (name -> callable), in the order parent, change, change,
    parent."""
    order = list(fns) + list(fns)[::-1]
    ms = {name: [] for name in fns}
    for name in order:
        fn = fns[name]
        ms[name].append(cuda_time_ms(
            lambda: [fn(**a) for a in calls.values()], reps))
    print(f"in turns, {label}: " + json.dumps(ms))
    return ms


# what `time_side` times: job -> (the entry's name in `side_entries`,
# one-call windows)
SIDE_JOBS = {"k1_frame": ("k1", False), "k1_dense": ("k1", False),
             "k4_frame": ("k4", False), "k5_ba_assemble": ("asm", False),
             "k5_ba_cost": ("cost", False), "b9": ("b9", False),
             "k6": ("cg", True), "gba": ("solve", True), "k8": ("k8", False),
             "k9": ("k9", False), "k7": ("k7", False),
             "sbp": ("sbp", False), "b6": ("b6", False),
             "r": ("r", False),
             "mm": ("mm", False)}


def side_entries(side, parent):
    """One side's entries (`--parent`): this checkout's, or the parent's
    (`build_parent`); every kernel library of that side loaded. For K6,
    `cg_args` turns a recorded `ba_schur_cg` call into the side's."""
    from orb_slam2_refactored_tpu_torch import kernels
    from orb_slam2_refactored_tpu_torch.ops import (hamming, matching, orb,
                                                    stereo)
    from orb_slam2_refactored_tpu_torch.ops import image as image_ops
    from orb_slam2_refactored_tpu_torch.optim import ba, pose_opt

    if side == "change":
        for name in kernels.SOURCES:
            kernels.load(name)
        return {"k1": hamming.masked_best2_gated, "k4": pose_opt.pose_optimize,
                "asm": ba.ba_assemble, "cost": ba.ba_cost,
                "b9": stereo.associate_from_best2, "cg": ba.ba_schur_cg,
                "cg_args": lambda c: c, "solve": ba.ba_solve,
                "k8": image_ops.build_pyramid, "k9": orb.spread_topk_levels,
                "k7": orb.angles_and_descriptors_learned_levels,
                "sbp": matching.search_by_projection_with_vis,
                "b6": matching.project_candidates, "r": r_side,
                "mm": mm_side}
    entries = build_parent(parent)
    old_kernels = sys.modules["parent_port.kernels"]
    for name in old_kernels.SOURCES:
        old_kernels.load(name)
    return entries


def time_side(side, parent, jobs_path):
    """`--time-side`: the device time and device operations of each job in
    `jobs_path` (`SIDE_JOBS`: name -> recorded calls) through one side's
    entries alone, in this process, every job run once before the first
    profiler window; K4's iteration on no observation; the global BA's
    host time. Prints them as the last line."""
    device = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f = side_entries(side, parent)
    jobs = torch.load(jobs_path, weights_only=False)
    if "k6" in jobs:
        jobs["k6"] = {n: f["cg_args"](c) for n, c in jobs["k6"].items()}
    runs = {}
    for key, calls in jobs.items():
        fn = f[SIDE_JOBS[key][0]]
        runs[key] = (lambda fn=fn, calls=calls:
                     [fn(**a) for a in calls.values()])
        runs[key]()
    torch.cuda.synchronize()
    out = {}
    for key, run in runs.items():
        try:
            if SIDE_JOBS[key][1]:
                ms, n_ops, _, _ = profiled_solve(run)
            else:
                ops = []
                ms, _ = profiled_ms(run, 20, ops)
                n_ops = ops[0]
            out[key] = {"device_ms": ms, "ops": n_ops}
        except RuntimeError as e:
            print(f"  {side} {key}: device time not measured ({e})")
            out[key] = None
    t0 = time.perf_counter()
    runs["gba"]()
    torch.cuda.synchronize()
    out["gba_host_ms"] = (time.perf_counter() - t0) * 1e3
    out["k4_iteration_us"] = k4_iteration_ms(f["k4"], device) * 1e3
    print(json.dumps(out))


def device_times_in_turns(parent, jobs):
    """Device time and operations of `jobs` (`SIDE_JOBS`) through each
    side, each side in a process of its own (`--time-side`), in the order
    parent, change, change, parent: in one process with both sides'
    kernels loaded, every profiler window lost a few launches on the H100
    (36 of 40 K1 launches, 136 of 140, 16 of 20), of either side, with any
    margin."""
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(parent)),
                        "parent_jobs.pt")
    torch.save(jobs, path)
    res = {}
    try:
        for side in ("parent", "change", "change", "parent"):
            t0 = time.perf_counter()
            done = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--time-side",
                 side, "--jobs", path, "--parent", parent],
                capture_output=True, text=True, timeout=900)
            lines = done.stdout.strip().splitlines()
            for line in lines[:-1]:
                print(f"  [{side}] {line}")
            if done.returncode != 0:
                print(done.stderr[-3000:])
                raise RuntimeError(f"--time-side {side}: rc "
                                   f"{done.returncode}")
            print(f"  [{side}] took {time.perf_counter() - t0:.1f} s")
            for key, v in json.loads(lines[-1]).items():
                res.setdefault(key, {"parent": [], "change": []})[
                    side].append(v)
    finally:
        os.remove(path)
    print("in turns, each side in a process of its own: " + json.dumps(res))
    return res


def host_in_turns(label, calls, fns, reps=1000):
    """The wrappers' host microseconds a run of the recorded `calls`
    through each of `fns` (`host_us`: nothing waits for the card), in the
    order parent, change, change, parent."""
    order = list(fns) + list(fns)[::-1]
    us = {name: [] for name in fns}
    for name in order:
        fn = fns[name]
        us[name].append(host_us(lambda: [fn(**a) for a in calls.values()],
                                reps))
    print(f"in turns, {label}: " + json.dumps(us))
    return us


def b6_r_against_parent(old, sbp_call, r_calls, mm_call, res):
    """With --parent: B6, R's two calls of the tracked frame and its
    motion-model search against the parent's entries (`build_parent`, each
    bound with its own C signature): outputs equal, then CUDA events and
    the wrappers' host time in turns, into `res`. Returns the B6 and R
    jobs for the device times."""
    from orb_slam2_refactored_tpu_torch.ops import matching

    b6 = {"b6": {k: sbp_call[k] for k in B6_ARGS if k in sbp_call}}
    b6_fns = {"parent": old["b6"], "change": matching.project_candidates}
    old_c = old["b6"](**b6["b6"])
    got = matching.project_candidates(**b6["b6"])
    same = [_same_bits(getattr(got, f), getattr(old_c, f))
            for f in matching.Candidates._fields]
    print(f"  B6: rows and slots equal to the parent's {same}")
    assert all(same), same
    rows_call, proj_call = r_calls
    r_jobs = {"motion_model": {**rows_call, "parent_valid": rows_call[
        "valid"] & (rows_call["dist"] <= rows_call["max_dist"])},
        "projection": proj_call}
    r_fns = {"parent": old["r"], "change": r_side}
    mm_fns = {"parent": old["mm"], "change": mm_side}
    for label, fns, calls in (("R", r_fns, r_jobs),
                              ("the motion-model search", mm_fns,
                               {"mm": mm_call})):
        for name, a in calls.items():
            got, ref = fns["change"](**a), fns["parent"](**a)
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            # R's rows mode gives (idx, keep), the parent's keep alone
            same = [bool(torch.equal(x, y)) for x, y in zip(got[::-1],
                                                            ref[::-1])]
            print(f"  {label} {name}: equal to the parent's {same}")
            assert all(same), (label, name, same)
    res["b6_card_ms"] = in_turns(
        "B6 on the tracked frame's projection search, CUDA events", b6,
        b6_fns)
    res["r_card_ms"] = in_turns(
        "R, the tracked frame's two calls, CUDA events", r_jobs, r_fns)
    res["mm_card_ms"] = in_turns(
        "the tracked frame's motion-model search, CUDA events",
        {"mm": mm_call}, mm_fns)
    res["b6_host_us"] = host_in_turns(
        "B6's wrapper, host us a call", b6, b6_fns)
    res["r_host_us"] = host_in_turns(
        "R's wrapper, host us for the tracked frame's two calls", r_jobs,
        r_fns)
    res["mm_host_us"] = host_in_turns(
        "the motion-model search, host us a call", {"mm": mm_call}, mm_fns)
    return b6, r_jobs


def compare_with_parent(parent, frame_k1, dense_k1, frame_k4, fb_k4,
                        asm_call, st_tail, k6_calls, gba_call, k8_calls,
                        k9_calls, k7_calls, sbp_call, r_calls, mm_call):
    """K1, K4, K5, B9, K6, K8, K9, K7, the tracked frame's projection
    search (B6, K1, R; the parent's plain gates, K1 and plain resolution
    where it predates B6 and R), and B6, R and the motion-model search
    (`b6_r_against_parent`) against the parent checkout's own
    entries (`build_parent`) on the same recorded arguments: outputs (K1,
    B9, K8, K9, K7 and the search exactly, K7 also given the plain
    version's angles;
    K4 bit for bit, reported; K5's largest difference, reported; K6 under
    the f64 yardstick), CUDA-event times in turns in this process, then
    (`device_times_in_turns`) device times and operations, K4's iteration
    on no observation and cell F's whole global BA (device time,
    operations, host time), each side in a process of its own."""
    from orb_slam2_refactored_tpu_torch.ops import (hamming, matching, orb,
                                                    stereo)
    from orb_slam2_refactored_tpu_torch.ops import image as image_ops
    from orb_slam2_refactored_tpu_torch.optim import ba, pose_opt

    old = build_parent(parent)
    given = {f"{n} given the plain angles": {
        **a, "angles": orb.angles_and_descriptors_learned_plain(
            a["levels"], a["ys"], a["xs"], a["counts"])[0]}
        for n, a in k7_calls.items()}
    for label, new_fn, old_fn, calls in (
            ("K8", image_ops.build_pyramid, old["k8"], k8_calls),
            ("K9", orb.spread_topk_levels, old["k9"], k9_calls),
            ("K7", orb.angles_and_descriptors_learned_levels, old["k7"],
             {**k7_calls, **given})):
        for name, a in calls.items():
            same = [bool(torch.equal(x, y)) for x, y in zip(new_fn(**a),
                                                            old_fn(**a))]
            print(f"  {label} {name}: equal to the parent's {label} {same}")
            assert all(same), (label, name, same)
    for name, a in {**frame_k1, **dense_k1}.items():
        same = all(torch.equal(x, y) for x, y in zip(
            hamming.masked_best2_gated(**a), old["k1"](**a)))
        print(f"  K1 {name}: equal to the parent's K1 {same}")
        assert same, name
    n_bits = 0
    k4_calls = {**frame_k4, **fb_k4}
    for name, a in k4_calls.items():
        k, o = pose_opt.pose_optimize(**a), old["k4"](**a)
        same = [bool(torch.equal(x, y)) for x, y in zip(k, o)]
        n_bits += all(same)
        print(f"  K4 {name}: (pose, inliers, count, cost) bit-equal to the "
              f"parent's K4 {same}; cost {float(k.final_cost)!r} vs "
              f"{float(o.final_cost)!r}")
    res = {"k4_bit_equal_calls": f"{n_bits} of {len(k4_calls)}"}
    res["k8_card_ms"] = in_turns(
        "K8 on frame 0's and a tracked frame's images, CUDA events",
        k8_calls, {"parent": old["k8"], "change": image_ops.build_pyramid})
    res["k9_card_ms"] = in_turns(
        "K9 on frame 0's and a tracked frame's rank rounds, CUDA events",
        k9_calls, {"parent": old["k9"], "change": orb.spread_topk_levels})
    res["k7_card_ms"] = in_turns(
        "K7 on frame 0's and cell I's tracked frame's keypoints (levels in "
        "K8's buffer), CUDA events", k7_calls,
        {"parent": old["k7"],
         "change": orb.angles_and_descriptors_learned_levels})
    k1_fns = {"parent": old["k1"], "change": hamming.masked_best2_gated}
    res["k1_frame_card_ms"] = in_turns(
        "K1 on the tracked frame's calls, CUDA events", frame_k1, k1_fns)
    res["k1_dense_card_ms"] = in_turns(
        "K1 on the dense calls (fallback, triangulation), CUDA events",
        dense_k1, k1_fns)
    res["k4_frame_card_ms"] = in_turns(
        "K4 on the tracked frame's calls, CUDA events", frame_k4,
        {"parent": old["k4"], "change": pose_opt.pose_optimize})
    cost_call = {n: v for n, v in asm_call.items()
                 if n not in ("index", "w_obs")}
    for name, new_fn, old_fn, a in (
            ("ba_assemble", ba.ba_assemble, old["asm"], asm_call),
            ("ba_cost", ba.ba_cost, old["cost"], cost_call)):
        rel = [_rel_err(x, y) for x, y in zip(new_fn(**a), old_fn(**a))]
        print(f"  K5 {name}: largest difference from the parent's, relative "
              f"to each array's largest magnitude: {rel}")
        res[f"k5_{name}_card_ms"] = in_turns(
            f"K5 {name} on the recorded window BA's first LM iteration, "
            "CUDA events", {name: a}, {"parent": old_fn, "change": new_fn})
    same = [bool(torch.equal(x, y)) for x, y in zip(
        stereo.associate_from_best2(**st_tail), old["b9"](**st_tail))]
    print(f"  B9: (u_right, depth, ok) equal to the parent's {same}")
    assert all(same), same
    res["b9_card_ms"] = in_turns(
        "B9, the stereo association after K1 on the recorded stereo frame, "
        "CUDA events", {"b9": st_tail},
        {"parent": old["b9"], "change": stereo.associate_from_best2})
    new_out, new_vis = matching.search_by_projection_with_vis(**sbp_call)
    old_out, old_vis = old["sbp"](**sbp_call)
    same = [bool(torch.equal(x, y)) for x, y in zip(
        (*new_out, new_vis), (*old_out, old_vis))]
    print(f"  the tracked frame's projection search: (idx, dist, valid, "
          f"vis) equal to the parent's {same}")
    assert all(same), same
    res["search_card_ms"] = in_turns(
        "the tracked frame's projection search, CUDA events",
        {"sbp": sbp_call}, {"parent": old["sbp"],
                            "change": matching.search_by_projection_with_vis})
    b6, r_jobs = b6_r_against_parent(old, sbp_call, r_calls, mm_call, res)
    par = {}
    for i, c in enumerate(k6_calls):
        yard, _, _ = cg_yardstick(
            {"change": ba.ba_schur_cg(**c),
             "parent": old["cg"](**old["cg_args"](c))},
            {**c, "W_obs": ba.w_obs_slot_rows(c["W_obs"])})
        par[i] = {n: (e_k / scale, e_p / scale)
                  for n, (e_k, e_p, scale) in yard.items()}
    print("  K6: each CG solve's largest difference from the plain solve in "
          "f64, relative to its largest magnitude (the side's, the f32 "
          "plain version's): " + json.dumps(par))
    c0 = k6_calls[0]
    res["k6_card_ms"] = in_turns(
        "K6, an LM iteration's CG solve of cell F's first global BA, CUDA "
        "events", {"k6": {"pa": old["cg_args"](c0), "c": c0}},
        {"parent": lambda **a: old["cg"](**a["pa"]),
         "change": lambda **a: ba.ba_schur_cg(**a["c"])})
    res["device"] = device_times_in_turns(parent, {
        "k1_frame": frame_k1, "k1_dense": dense_k1, "k4_frame": frame_k4,
        "k5_ba_assemble": {"a": asm_call}, "k5_ba_cost": {"a": cost_call},
        "b9": {"b9": st_tail}, "k6": {"k6": c0}, "gba": {"gba": gba_call},
        "k8": k8_calls, "k9": k9_calls, "k7": k7_calls,
        "sbp": {"sbp": sbp_call}, "b6": b6, "r": r_jobs,
        "mm": {"mm": mm_call}})
    print("against the parent " + json.dumps(res))
    return res


def cell_a_steps(pkg, imgs, depths, gt, device):
    """Cell A (`bench_config(True)`, 120 frames) through the tracker of the
    port package `pkg` (this one's name, or `parent_port`): the step's
    host ms on a synchronizing clock after WARMUP_FRAMES (median, p90) and
    the ATE."""
    import dataclasses
    import importlib

    from orb_slam2_refactored_tpu_torch.io.evaluation import ate_rmse

    tracking = importlib.import_module(pkg + ".slam.tracking")
    map_state = importlib.import_module(pkg + ".slam.map_state")
    cfg = bench_config(True)
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw["map_capacity"] = map_state.MapCapacity(
        **dataclasses.asdict(cfg.map_capacity))
    tracker = tracking.Tracker(tracking.TrackerConfig(**kw), device=device)
    steps = []
    for i in range(len(imgs)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tracker.track_rgbd(imgs[i], depths[i].astype(np.float32),
                           timestamp=i / 30.0)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
    tracker.flush()
    ate, _ = ate_rmse(np.stack(tracker.trajectory), gt, align="se3")
    x = np.asarray(steps[WARMUP_FRAMES:])
    return {"step_ms_median": float(np.median(x)),
            "step_ms_p90": float(np.percentile(x, 90)), "ate_m": ate}


def cell_a_against_parent(imgs, depths, gt, device):
    """With --parent (after `build_parent`): cell A through the parent's
    tracker and this one's in turns (parent, change, change, parent): the
    step's median and p90 and the ATE."""
    res = {"parent": [], "change": []}
    for side in ("parent", "change", "change", "parent"):
        pkg = ("parent_port" if side == "parent"
               else "orb_slam2_refactored_tpu_torch")
        res[side].append(cell_a_steps(pkg, imgs, depths, gt, device))
    print("cell A against the parent, in turns " + json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# phase 3m: pipelined mode, the bench's setting in its scored segments
# ---------------------------------------------------------------------------

# frames in flight: the RGB-D segment and the loop circuit at the bench's
# 6 (`bench.py:100-101`, `:614-615`), the mono probe at 6 (`:669-670`),
# the stereo segment at 3 (`:744-750`)
PIPE_DEPTHS = {"A": 6, "C": 3, "G": 6, "F": 6}


def run_pipelined_cells(imgs, depths, gt, left, right, frames_f, gt_f,
                        device, sync, card):
    """A-pipe, C-pipe, G-pipe and F-pipe: cells A, C, G and F (loop
    closing on) pipelined, with their synchronous cells' gates and launch
    checks (`run_main_path`, `run_mono_orbit`, `run_circuit`); F-pipe
    holds tracking OK at the end and a loop closed, as the bench's loop
    circuit does (`bench.py:614-650`), and records its ATE and lost
    frames: at depth 6 the JAX package itself loses 66 of the circuit's
    170 frames from frame 67 on the CPU (PERF.md §6, PR 19), so the
    synchronous cell's 6 cm is not its gate. Each cell's ATE, step
    median, p90 and largest, fps, host ms of the frames that made
    keyframes, pumps that met a read not yet landed and the
    `use_ref.item()` wait a frame, printed beside its synchronous cell
    (`sync`) from this process."""
    out = {
        "A": run_main_path(imgs, depths, gt, device, local_ba=True,
                           depth=PIPE_DEPTHS["A"])[0],
        "C": run_main_path(left, right, gt, device, local_ba=True,
                           stereo=True, depth=PIPE_DEPTHS["C"])[0],
        "G": run_mono_orbit(imgs, gt, device, depth=PIPE_DEPTHS["G"])[0],
        "F": run_circuit("F", True, frames_f, gt_f, device,
                         depth=PIPE_DEPTHS["F"])[0],
    }
    f = out["F"]
    print(f"F-pipe gates: state {f['state']} (1: OK), loops "
          f"{f['loops_closed']}; recorded: ATE {f['ate_m']:.7f} m, "
          f"{f['lost_frames']} frames lost")
    assert f["loops_closed"] >= 1, "F-pipe: no loop closed"
    print(f"phase 3m ({card}; host clock around torch.cuda.synchronize(), "
          f"after {WARMUP_FRAMES} warm-up frames, G over its measured lap):")
    for cell, depth in PIPE_DEPTHS.items():
        for mode, st in ((f"{cell} synchronous", sync[cell]),
                         (f"{cell}-pipe depth {depth}", out[cell])):
            kf = np.asarray(st["kf_frame_ms"])
            print(f"  {mode}: " + json.dumps({
                "ate_m": st.get("ate_m", st.get("ate_sim3_m")),
                **{k: st[k] for k in (
                    "step_ms_median", "step_ms_p90", "step_ms_max",
                    "fps_after_warmup", "pumps_not_ready",
                    "use_ref_wait_ms_median", "use_ref_wait_ms_mean")},
                "keyframe_frames": len(kf),
                "keyframe_frame_ms_median": float(np.median(kf)),
                "keyframe_frame_ms_max": float(kf.max())}))
    return out


# ---------------------------------------------------------------------------
# cells E and F: loop closing and global BA
# ---------------------------------------------------------------------------

def circuit_trajectory(n, overlap=30, radius=0.7):
    """The panning circuit of `tests/test_organic_loop.py:23-40` and
    `bench.py:555-593`: the camera orbits the room centre while yawing
    through 2 pi in n - overlap frames, then re-sees the start views in the
    last `overlap`; world->camera poses."""
    from orb_slam2_refactored_tpu_torch.io.synthetic import _np_pose_inverse

    poses = []
    for i in range(n):
        a = 2.0 * np.pi * i / (n - overlap)
        q = np.array([np.cos(a / 2), 0.0, np.sin(a / 2), 0.0], np.float32)
        pose_wc = np.concatenate([q, np.array(
            [radius * np.sin(a), 0.0, radius * (1 - np.cos(a)) * 0.5],
            np.float32)])
        poses.append(_np_pose_inverse(pose_wc).astype(np.float32))
    return np.stack(poses)


def circuit_frames(cell):
    """Cell E: the organic-loop test's QVGA circuit (`tests/
    test_organic_loop.py:43-57`: box room 1.7 x 1.3 x 2.7, f32 images,
    depth with 2 % noise from seed 23). Cell F: the bench's VGA circuit
    (`bench.py:555-593`: box room 1.8 x 1.4 x 3.0, uint8 images, f16 depth
    with 1 % noise from seed 23). Both: distinct textures, 170 frames."""
    from orb_slam2_refactored_tpu_torch.io.synthetic import (
        SyntheticScene, box_room)

    gt = circuit_trajectory(CIRCUIT_FRAMES)
    rng = np.random.default_rng(23)
    frames = []
    if cell == "E":
        scene = SyntheticScene(width=320, height=240, fx=260.0, fy=260.0,
                               planes=box_room(1.7, 1.3, 2.7, -2.7,
                                               distinct_textures=True))
        for pose in gt:
            img, depth = scene.render(pose)
            frames.append((img, depth * (1 + rng.normal(
                0, 0.02, depth.shape).astype(np.float32))))
        return frames, gt
    scene = SyntheticScene(width=640, height=480, fx=520.0, fy=520.0,
                           planes=box_room(1.8, 1.4, 3.0, -3.0,
                                           distinct_textures=True))
    for pose in gt:
        img, depth = scene.render(pose)
        frames.append((np.clip(img, 0, 255).astype(np.uint8),
                       (depth * (1 + rng.normal(0, 0.01, depth.shape)))
                       .astype(np.float16)))
    return frames, gt


def circuit_config(cell, loop):
    """Cell E: `tests/test_organic_loop.py:60-76`'s configuration (600
    features, 4 levels, 1024 words, `MapCapacity(96, 16384, 600)`). Cell F:
    the bench's (`bench_config`: 1000 features, 8 levels,
    `MapCapacity(128, 32768, 1000)`, local BA on, synchronous) with
    `bench.py:614-615`'s loop settings. Both: a keyframe at least every 8
    frames and the 10-keyframe covisibility window."""
    import dataclasses

    from orb_slam2_refactored_tpu_torch.slam.map_state import MapCapacity
    from orb_slam2_refactored_tpu_torch.slam.tracking import TrackerConfig

    if cell == "E":
        return TrackerConfig(
            width=320, height=240, fx=260.0, fy=260.0, cx=160.0, cy=120.0,
            bf=0.08 * 260.0, n_features=600, n_levels=4,
            enable_loop_closing=loop, vocab_words=1024, kf_max_interval=8,
            local_map_window=10,
            map_capacity=MapCapacity(max_keyframes=96, max_points=16384,
                                     max_features=600))
    return dataclasses.replace(bench_config(True), local_map_window=10,
                               kf_max_interval=8, enable_loop_closing=loop)


def run_circuit(cell, loop, frames, gt, device, record=None, gated=True,
                depth=0, loop_checks=None):
    """One run of a loop cell through `Tracker.track_rgbd`, every launch
    counter set to 0 just before and read just after; the ATE of the
    corrected trajectory (`corrected_frame_poses`), the loops closed and
    the host times of `_close_loop` and `kf.gba_merge`. With `record` (a
    dict), the arguments of the run's global-BA calls (`compact_points`,
    `ba_solve`) and pose-graph solves are recorded into it, and with
    `loop_checks` (a list) the loop check's projection searches (B6, K1,
    R; `matching.search_by_projection`) into that. Unless
    `gated` is false (`--c13`, which records and gates nothing), tracking
    must end OK and every kernel of the path must launch. `depth` > 0 runs
    it pipelined with that many frames in flight."""
    from orb_slam2_refactored_tpu_torch import kernels
    from orb_slam2_refactored_tpu_torch.io.evaluation import ate_rmse
    from orb_slam2_refactored_tpu_torch.ops import matching
    from orb_slam2_refactored_tpu_torch.slam import loop_closing
    from orb_slam2_refactored_tpu_torch.slam.system import (
        corrected_frame_poses)
    from orb_slam2_refactored_tpu_torch.slam.tracking import Tracker
    from orb_slam2_refactored_tpu_torch.utils.timing import StageTimer

    tracker = Tracker(pipelined(circuit_config(cell, loop), depth),
                      device=device)
    timer = StageTimer(device)
    real = tracker._close_loop

    def close_loop(*a, **k):
        with tracker.timer.time("loop.close_loop"):
            return real(*a, **k)

    tracker._close_loop = close_loop
    with contextlib.ExitStack() as stack:
        if record is not None:
            for name in ("compact_points", "ba_solve", "pose_graph_solve"):
                stack.enter_context(recording(record.setdefault(name, []),
                                              (loop_closing, name)))
        if loop_checks is not None:
            stack.enter_context(recording(
                loop_checks, (matching, "search_by_projection"),
                like=matching.search_by_projection_with_vis))
        kernels.reset_counts()
        t0 = time.perf_counter()
        kf_made = [timed_frame(timer, tracker, partial(
            tracker.track_rgbd, img, dep.astype(np.float32),
            timestamp=i / 30.0)) for i, (img, dep) in enumerate(frames)]
        tracker.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.counts()
    est = corrected_frame_poses(tracker)
    assert est.shape == gt.shape and np.isfinite(est).all()
    ate, _ = ate_rmse(est, gt, align="se3")
    lc = tracker.loop_closer
    info = tracker.last_loop_info
    samples = tracker.timer.samples
    stats = {
        "cell": cell, "loop_closing": loop, "frames": len(frames),
        "ate_m": ate, "loops_closed": lc.loops_closed if lc else 0,
        "state": int(tracker.state),
        "lost_frames": sum(1 for t in tracker.track_info if t.get("lost")),
        "keyframes_alive": len(tracker.graph.alive_kfs()),
        "map_points_alive": int(tracker.graph.pt_alive.sum()),
        "last_loop_info": None if info is None else {
            k: (list(v) if isinstance(v, tuple) else v)
            for k, v in info.items()},
        "close_loop_ms": [x * 1e3 for x in samples.get("loop.close_loop",
                                                      [])],
        "gba_merge_ms": [x * 1e3 for x in samples.get("kf.gba_merge", [])],
        "kf_stages": kf_stage_ms(tracker),
        "graph": type(tracker.graph).__name__,
        **step_stats(timer.samples["step"], kf_made, tracker),
        "wall_s": wall, "launches": launches}
    mode = f", pipelined depth {depth}" if depth else ""
    print(f"cell {cell} (loop closing {'on' if loop else 'off'}{mode}) "
          + json.dumps(stats))
    if not gated:
        return stats, tracker
    assert stats["state"] == 1, tracker.track_info[-3:]
    for k, v in launches.items():
        if k == LARGE_KERNEL or off_cell(k, v, f"cell {cell}"):
            continue  # `extraction_launches` holds K9's large kernel
        if k in ("stereo_sad", LEARNED_KERNEL):
            assert v == 0, f"{k} launched on cell {cell}"
        elif k in LOOP_KERNELS:
            # the global BA runs only after a loop closed
            assert (v > 0) == (stats["loops_closed"] > 0), (k, v, cell)
        else:
            assert v > 0, f"kernel {k} never launched on cell {cell}"
    extraction_launches(launches, len(frames), f"cell {cell}")
    return stats, tracker


def gate_loop_cell(on, off):
    """The organic-loop test's gates (`tests/test_organic_loop.py:85-114`):
    tracking OK at the end, at least one loop closed, the corrected ATE
    with loops below the ATE without, and below 6 cm."""
    cell = on["cell"]
    print(f"cell {cell} gates: loops {on['loops_closed']}, ATE with loops "
          f"{on['ate_m']:.7f} m, without {off['ate_m']:.7f} m (gate "
          f"{LOOP_ATE_M} m)")
    assert on["loops_closed"] >= 1, f"cell {cell}: no loop closed"
    assert on["ate_m"] < off["ate_m"], (cell, on["ate_m"], off["ate_m"])
    assert on["ate_m"] < LOOP_ATE_M, (cell, on["ate_m"])


# --arena: the C++ map-graph arena (`native.py`) measured beside the
# Python graph. The tracker does not take it yet (ROADMAP.md, A1): cell F's
# loops-help gate does not hold on it on the H100.


def kf_stage_ms(tracker):
    """Count, median and p90 (host ms, synchronized) of every `kf.*` stage
    of a tracker's timer."""
    return {k: {"n": len(v), "median_ms": float(np.median(v) * 1e3),
                "p90_ms": float(np.percentile(v, 90) * 1e3)}
            for k, v in sorted(tracker.timer.samples.items())
            if k.startswith("kf.")}


@contextlib.contextmanager
def native_graph():
    """Trackers built inside take the C++ arena: the `MapGraph` that
    `slam/tracking.py` constructs is replaced by `native.NativeMapGraph`
    (the tracker itself offers no switch)."""
    from orb_slam2_refactored_tpu_torch import native
    from orb_slam2_refactored_tpu_torch.slam import tracking

    old = tracking.MapGraph
    tracking.MapGraph = native.NativeMapGraph
    try:
        yield
    finally:
        tracking.MapGraph = old


def stage_pairs(py, arena):
    """Each `kf.*` stage's median and p90 on the Python graph and on the
    arena, side by side."""
    return {k: {"python_median_ms": py.get(k, {}).get("median_ms"),
                "arena_median_ms": arena.get(k, {}).get("median_ms"),
                "python_p90_ms": py.get(k, {}).get("p90_ms"),
                "arena_p90_ms": arena.get(k, {}).get("p90_ms")}
            for k in sorted(set(py) | set(arena))}


def run_arena(device, card):
    """`--arena`: build the port's arena from `csrc/map_graph.cpp` with g++
    on this host (the compiler and the build's seconds printed); then cell
    A (120 VGA frames, local BA on, `run_main_path` with its gates),
    cells E and F (loop closing off and on, `run_circuit`) and F-pipe (F,
    loops on, pipelined at phase 3m's depth) on the Python graph and on
    the arena. Prints the ATEs, loops, keyframes, points, the
    tracked step's median and p90, `_close_loop` ms and every `kf.*`
    stage's median and p90 side by side, and the organic-loop gates'
    outcomes for E and F on each graph, recorded and not held (as
    `--c13`): the arena is measured here, not brought up. Returns the
    table."""
    from orb_slam2_refactored_tpu_torch import native

    t0 = time.perf_counter()
    path = native.build_library()
    res = {"build": {"compiler": native.compiler_version(),
                     "flags": " ".join(native.FLAGS),
                     "build_s": time.perf_counter() - t0,
                     "library": os.path.relpath(path)}}
    print(f"arena: map graph built ({card}): " + json.dumps(res["build"]))
    imgs, depths, gt = bench_frames(N_FRAMES)
    graphs = {"python": contextlib.nullcontext, "arena": native_graph}
    keys = ("ate_m", "keyframes_created", "keyframes_alive",
            "window_ba_solves", "map_points_alive", "step_ms_median",
            "step_ms_p90")
    a = {}
    for graph, ctx in graphs.items():
        with ctx():
            a[graph] = run_main_path(imgs, depths, gt, device, local_ba=True,
                                     label=f"{graph} graph")
    assert type(a["arena"][1].graph).__name__ == "NativeMapGraph"
    res["A"] = {g: {k: a[g][0][k] for k in keys} for g in graphs}
    res["A"]["kf_stages"] = stage_pairs(kf_stage_ms(a["python"][1]),
                                        kf_stage_ms(a["arena"][1]))
    print(f"arena cell A ({card}): " + json.dumps(res["A"]))
    del a
    keys = ("ate_m", "loops_closed", "keyframes_alive", "map_points_alive",
            "close_loop_ms", "gba_merge_ms", "last_loop_info", "wall_s")
    for cell in ("E", "F"):
        frames, cgt = circuit_frames(cell)
        runs, pipe = {}, {}
        for graph, ctx in graphs.items():
            with ctx():
                off, _ = run_circuit(cell, False, frames, cgt, device,
                                     gated=False)
                on, _ = run_circuit(cell, True, frames, cgt, device,
                                    gated=False)
                if cell == "F":
                    p, _ = run_circuit(cell, True, frames, cgt, device,
                                       gated=False, depth=PIPE_DEPTHS[cell])
                    pipe[graph] = {k: p[k] for k in keys + ("lost_frames",
                                                            "state")}
            runs[graph] = (off, on)
        del frames
        assert runs["arena"][1]["graph"] == "NativeMapGraph"
        res[cell] = {g: {"loop_off": {k: off[k] for k in keys},
                         "loop_on": {k: on[k] for k in keys},
                         "gates": {"state_ok": off["state"] == on["state"]
                                   == 1,
                                   "loop_closed": on["loops_closed"] >= 1,
                                   "loops_help": on["ate_m"] < off["ate_m"],
                                   "under_6cm": on["ate_m"] < LOOP_ATE_M}}
                     for g, (off, on) in runs.items()}
        if pipe:
            res[cell + "-pipe"] = pipe
            print(f"arena cell {cell}-pipe ({card}): " + json.dumps(pipe))
        res[cell]["kf_stages_loop_on"] = stage_pairs(
            runs["python"][1]["kf_stages"], runs["arena"][1]["kf_stages"])
        print(f"arena cell {cell} ({card}): ATE off / on "
              + ", ".join(f"{g} {off['ate_m']:.7f} / {on['ate_m']:.7f} m"
                          for g, (off, on) in runs.items())
              + "; " + json.dumps(res[cell]))
    return res


def block_splits(n_in, n_out, block=8):
    """Each output's taps split at the first multiple of `block` of the
    input index inside them, one chain where none falls inside: the
    partial sums of an FFMA GEMM's 8-wide K blocks and nothing else."""
    from orb_slam2_refactored_tpu_torch.ops import image as image_ops

    idx, _ = image_ops.resize_taps(n_in, n_out)
    first, count = idx[:, 0], idx[:, 1]
    cut = (first // block + 1) * block
    return np.where(cut < first + count, cut - first, count).astype(np.int32)


K8_ORDERS = ("gemm", "chain", "block8")


@contextlib.contextmanager
def k8_order(order):
    """K8 fed one of three split tables through its plan
    (`gemm_tap_splits` replaced, the plan caches cleared): the card's
    GEMM's (the tracker's own), one `fmaf` chain an output, or splits at
    8-wide input blocks only: a last-bit change of the pyramid."""
    from orb_slam2_refactored_tpu_torch.ops import image as image_ops

    found = image_ops.gemm_tap_splits
    splits = {
        "gemm": found,
        "chain": lambda n_in, n_out, *a: image_ops.resize_taps(
            n_in, n_out)[0][:, 4].copy(),
        "block8": lambda n_in, n_out, *a: block_splits(n_in, n_out)}[order]
    caches = (image_ops._tap_records, image_ops._pyramid_plan)
    image_ops.gemm_tap_splits = splits
    for c in caches:
        c.cache_clear()
    try:
        yield
    finally:
        image_ops.gemm_tap_splits = found
        for c in caches:
            c.cache_clear()


def run_c13(device):
    """`--c13`: cells E and F, loop closing off and on, under each of
    K8's three orders (`k8_order`). Each run's ATE pair and whether the
    cells' gates hold (F: loops beat no loops; E: also under 6 cm) are
    recorded, not gated: hazard C13's margin under a last-bit change of
    the pyramid. Returns the table."""
    cells = {}
    for cell in ("E", "F"):
        t0 = time.perf_counter()
        cells[cell] = circuit_frames(cell)
        print(f"cell {cell}: {len(cells[cell][0])} frames rendered in "
              f"{time.perf_counter() - t0:.1f} s")
    table = {}
    for order in K8_ORDERS:
        for cell, (frames, cgt) in cells.items():
            t0 = time.perf_counter()
            with k8_order(order):
                off, _ = run_circuit(cell, False, frames, cgt, device,
                                     gated=False)
                on, _ = run_circuit(cell, True, frames, cgt, device,
                                    gated=False)
            row = {"ate_off_m": off["ate_m"], "ate_on_m": on["ate_m"],
                   "loops_closed": on["loops_closed"],
                   "loops_beat_no_loops": on["ate_m"] < off["ate_m"],
                   "on_under_6cm": on["ate_m"] < LOOP_ATE_M,
                   "state_ok": [off["state"] == 1, on["state"] == 1],
                   "lost_frames": [off["lost_frames"], on["lost_frames"]],
                   "wall_s": time.perf_counter() - t0}
            table.setdefault(order, {})[cell] = row
            print(f"c13 {order} cell {cell}: " + json.dumps(row))
    return table


# the fused CG's yardstick: the plain solve in f64; the kernel may lie at
# most CG_FACTOR times as far from it as the f32 plain solve does, plus
# CG_FLOOR of the f64 result's largest magnitude. The floor stands for the
# f32 CG's own spread, which one f32 run does not show: `cg_readings`
# reads it on every LM iteration as the plain solve with its keyframes
# relabeled (the same sums in CG_RELABELS other orders). On cell F's
# first global BA on the H100 that spread reached 1.6e-4 of max |f64| in
# U^T dp where the plain solve read 2.3e-5 (and twice the bound on
# another iteration), while the plain solve on inputs rounded to tf32 or
# bf16 lay 0.4 to 69 times max |f64| away: the system amplifies input
# rounding ~2000-fold, so CG_FLOOR sits inside f32's spread and far below
# any lower precision
CG_FACTOR = 2.0
CG_FLOOR = 1e-4
CG_RELABELS = 4


def cg_yardstick(outs, plain_args):
    """For each output (dp, U^T dp) of `outs` (a call's (x, ut), or several
    such, named): its largest difference from `cg_solve_plain` in f64 on
    `plain_args` (W_obs in the slot layout), against the f32 plain
    version's. Returns {name: (e_kernel, e_plain, f64 scale)} for each of
    outs' entries, the plain f32 result and the f64 one."""
    from orb_slam2_refactored_tpu_torch.optim import ba

    # the plain scatter (`index_add_`) sums with float atomics on the card;
    # deterministic mode gives it one order, so the f32 plain version's
    # distance from f64 (the yardstick) is the same in every run: without
    # it, one LM iteration's U^T dp moved from 8.6e-5 to 1.3e-5 of its
    # largest magnitude between two runs on the H100
    with deterministic():
        ref = ba.cg_solve_plain(**plain_args)
        exact = ba.cg_solve_plain(**{n: _f64(v)
                                     for n, v in plain_args.items()})
    res = {}
    for who, out in outs.items():
        for name, k, r, e in zip(("dp", "ut"), out, ref, exact):
            res[f"{who} {name}"] = (float((k.double() - e).abs().max()),
                                    float((r.double() - e).abs().max()),
                                    float(e.abs().max()))
    return res, ref, exact


def relabeled_plain(plain_args, perm):
    """`cg_solve_plain` on the same system with its keyframes relabeled by
    `perm`: the same sums in other orders; dp in the original labels."""
    from orb_slam2_refactored_tpu_torch.optim import ba

    a = dict(plain_args)
    K, N = a["obs_pt"].shape
    for n in ("Hpp_d", "g_p", "obs_pt", "obs_ok", "free"):
        a[n] = a[n][perm]
    a["W_obs"] = a["W_obs"].reshape(K, N, 18)[perm].reshape(K * N, 18)
    x, ut = ba.cg_solve_plain(**a)
    out = torch.empty_like(x)
    out[perm] = x
    return out, ut


def mantissa(v, bits):
    """An f32 tensor `v` rounded to nearest at `bits` mantissa bits (10:
    tf32's, 7: bf16's); any other value unchanged."""
    if not (isinstance(v, torch.Tensor) and v.dtype == torch.float32):
        return v
    drop = 23 - bits
    i = v.contiguous().view(torch.int32)
    return ((i + (1 << (drop - 1))) & ~((1 << drop) - 1)).view(torch.float32)


def cg_readings(calls, device):
    """On each recorded `ba_schur_cg` call: the fused CG against the f64
    yardstick (`cg_yardstick`) and two calls bit-equal; beside it the f32
    CG's own spread (the largest difference from f64 of the plain solve
    with its keyframes relabeled, `relabeled_plain`), the lower-precision
    controls (the plain solve on inputs rounded to tf32 and to bf16) and
    where the kernel's U^T dp gap comes from: U^T of the kernel's own dp in
    f64 against the kernel's U^T dp (the back-substitution's rounding) and
    against the f64 U^T dp (carried from dp). Fails unless the kernel
    meets the bound on every call and the bf16 control misses it on one."""
    from orb_slam2_refactored_tpu_torch.optim import ba

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(0)
    K = calls[0]["obs_pt"].shape[0]
    perms = [torch.randperm(K, generator=gen).to(device)
             for _ in range(CG_RELABELS)]
    k6_err, worst = 0.0, {}
    for i, c in enumerate(calls):
        out = ba.ba_schur_cg(**c)
        assert all(torch.equal(x, y) for x, y in zip(out,
                                                     ba.ba_schur_cg(**c)))
        plain_args = {**c, "W_obs": ba.w_obs_slot_rows(c["W_obs"])}
        # readings, not the yardstick: torch's own (atomic) sum orders are
        # more of the spread, and in deterministic mode these readings
        # took 68 s of a run on the H100
        others = {f"relabeled{j}": relabeled_plain(plain_args, pm)
                  for j, pm in enumerate(perms)}
        for tag, bits in (("tf32", 10), ("bf16", 7)):
            others[tag] = ba.cg_solve_plain(**{
                n: mantissa(v, bits) for n, v in plain_args.items()})
        yard, ref, exact = cg_yardstick({"kernel": out, **others},
                                        plain_args)
        k6_err = max(k6_err, *(float((x - y).abs().max())
                               for x, y in zip(out, ref)))
        ut_of_dp = ba.ba_schur_ut_plain(
            out[0].double(), plain_args["W_obs"].double(), c["obs_pt"],
            c["obs_ok"], c["G"].shape[0])
        for name in ("dp", "ut"):
            e_k, e_p, scale = yard[f"kernel {name}"]
            bound = CG_FACTOR * e_p + CG_FLOOR * scale
            read = {"kernel": e_k / bound,
                    "relabeled": max(yard[f"relabeled{j} {name}"][0]
                                     for j in range(CG_RELABELS)) / bound,
                    "tf32": yard[f"tf32 {name}"][0] / bound,
                    "bf16": yard[f"bf16 {name}"][0] / bound}
            for who, r in read.items():
                worst[f"{who} {name}"] = max(worst.get(f"{who} {name}", 0.0),
                                             r)
            line = (f"    LM iteration {i} {name}: kernel {e_k / scale:.3g}, "
                    f"plain f32 {e_p / scale:.3g}, relabeled up to "
                    f"{read['relabeled'] * bound / scale:.3g}, tf32 inputs "
                    f"{read['tf32'] * bound / scale:.3g}, bf16 inputs "
                    f"{read['bf16'] * bound / scale:.3g} of max |f64| "
                    f"{scale:.4g}; kernel {read['kernel']:.3g} of the bound")
            if name == "ut":
                e_bs = float((out[1].double() - ut_of_dp).abs().max())
                e_dp = float((ut_of_dp - exact[1]).abs().max())
                line += (f"; U^T of the kernel's dp in f64: from the "
                         f"kernel's U^T dp {e_bs / scale:.3g}, from f64's "
                         f"{e_dp / scale:.3g}")
            print(line)
    print(f"  K6 ba_schur_cg on the {len(calls)} LM iterations of the global "
          f"BA: largest share of the yardstick's bound {json.dumps(worst)} "
          f"(bound {CG_FACTOR} x the f32 plain version's difference from "
          f"f64 + {CG_FLOOR} x max |f64|); two calls bit-equal; largest "
          f"difference from the f32 plain version {k6_err:.3g}; "
          f"{time.perf_counter() - t0:.1f} s")
    assert max(worst["kernel dp"], worst["kernel ut"]) <= 1.0, worst
    # the yardstick tells a solve at bf16's precision
    assert max(worst["bf16 dp"], worst["bf16 ut"]) > 1.0, worst
    return k6_err


# the whole global BA's gate against its f64 plain solve: poses within
# GBA_POSE_M / GBA_ROT_RAD, points within GBA_POINT_M, final costs within
# GBA_COST_REL relative
GBA_POSE_M = 1e-3
GBA_ROT_RAD = 1e-3
GBA_POINT_M = 1e-2
GBA_COST_REL = 1e-3


def _rounded(v, bits):
    """`mantissa(v, bits)` on every f32 tensor of `v` (a tensor, a named
    tuple of them or anything else, unchanged)."""
    if isinstance(v, tuple) and hasattr(v, "_fields"):
        return type(v)(*(_rounded(x, bits) for x in v))
    return mantissa(v, bits)


def plain_gba(sa, f64=False, bits=None):
    """The global BA of `sa` through the plain versions (assembly, cost,
    CG) in torch's deterministic mode; in f64 with `f64`, on inputs rounded
    to `bits` mantissa bits with `bits`. Returns the result and its LM
    trace (`lm_trace`)."""
    from orb_slam2_refactored_tpu_torch.optim import ba

    args = {n: _f64(v) for n, v in sa.items()} if f64 else dict(sa)
    if bits is not None:
        args = {n: _rounded(v, bits) for n, v in args.items()}
    names = ("ba_assemble", "ba_cost")
    real = {n: getattr(ba, n) for n in names + ("ba_schur_cg",)}
    for n in names:
        setattr(ba, n, getattr(ba, n + "_plain"))
    ba.ba_schur_cg = ba.cg_solve_plain
    try:
        with deterministic(), cost_trace() as costs:
            res = ba.ba_solve(**args)
    finally:
        for n, fn in real.items():
            setattr(ba, n, fn)
    return res, lm_trace(costs, sa.get("lambda0", 1e-4))


@contextlib.contextmanager
def cost_trace():
    """Inside the block, the cost of every `optim.ba.ba_cost` call is
    appended to the list it yields."""
    from orb_slam2_refactored_tpu_torch.optim import ba

    real, out = ba.ba_cost, []

    def traced(*args, **kwargs):
        r = real(*args, **kwargs)
        out.append(float(r[0]))
        return r

    ba.ba_cost = traced
    try:
        yield out
    finally:
        ba.ba_cost = real


def lm_trace(vals, lambda0):
    """Each LM iteration's trial cost, its decision ("accept", "reject", or
    "done" once the solve has converged and changes nothing) and the lambda
    after it, from a solve's `ba_cost` values (the initial cost, one trial
    an iteration, the final chi2 pass), the decisions replayed as
    `optim/ba.py::_ba_solve_f32` makes them."""
    cost, lam, done, out = vals[0], lambda0, False, []
    for c in vals[1:-1]:
        if done:
            out.append((c, "done", lam))
            continue
        lam = min(max(lam * 0.4 if c < cost else lam * 5.0, 1e-8), 1e5)
        if c < cost:
            done = (cost - c) / max(cost, 1e-12) < 1e-5
            cost = c
        out.append((c, "accept" if c <= cost else "reject", lam))
    return out


def gba_gap(a, b, p):
    """Largest pose (rotation, translation) and live-point difference of
    two global-BA results, with both final costs."""
    from orb_slam2_refactored_tpu_torch.geometry import se3

    d = se3.log(se3.compose(a.kf_pose.double(),
                            se3.inverse(b.kf_pose.double())))
    pts = (a.pt_pos.double() - b.pt_pos.double())[p.pt_valid]
    return (float(d[:, :3].abs().max()), float(d[:, 3:].abs().max()),
            float(pts.abs().max()), float(a.final_cost),
            float(b.final_cost))


def gba_within(g):
    rot, trans, pts, c_a, c_b = g
    return (rot <= GBA_ROT_RAD and trans <= GBA_POSE_M and pts <= GBA_POINT_M
            and abs(c_a - c_b) <= GBA_COST_REL * c_b)


def check_gba(rec, device):
    """Phase 4 on the first global BA of cell F: its problem holds every
    live point of the map (none dropped: P = 32768 at the bench's
    capacity); K5's `w_obs` mode on the first LM iteration's arguments:
    `place` equal to the plain index's, Hpp, g_p and Hll|g_l bit-equal to
    the dense mode's launch and within `k5_agrees` of the plain version,
    the live rows (in the index's order) within `k5_agrees` of the plain
    rows gathered through the index, two calls bit-equal; the whole global
    BA with K5 and K6, one launch of each an LM iteration, its K6 calls
    recorded: on each, the fused CG against `cg_solve_plain` (the f64
    yardstick, `cg_readings`: at most CG_FACTOR x the f32 plain
    version's difference plus CG_FLOOR) and two calls bit-equal; the whole
    global BA against the plain global BA in f64 on the card (torch's
    deterministic mode; `gba_within`): poses within 1e-3 m / 1e-3 rad,
    points within 1e-2 m, final costs within 1e-3 relative, the cost
    lowered, and the plain solve on inputs rounded to bf16 outside that
    gate (the control); each solve's LM decisions printed, and the f32
    plain solve's distance from f64 and the kernel path's from it read,
    not held; and the loop's pose-graph
    solve on the card against the same solve on the CPU: poses within
    1e-3, costs within 1e-3 relative. Returns the rows of
    `ba_assemble_w_obs` and `ba_schur_cg`, the recorded K6 calls, the
    solve's and the pose graph's arguments and the solve's launches."""
    from orb_slam2_refactored_tpu_torch import kernels
    from orb_slam2_refactored_tpu_torch.optim import ba, pose_graph

    full = rec["compact_points"][0]["p"]
    sa = dict(rec["ba_solve"][0])
    p = sa["p"]
    K, N = p.obs_pt.shape
    P, Q = full.pt_pos.shape[0], p.pt_pos.shape[0]
    n_live = int(full.pt_valid.sum())
    print(f"  global BA problem: K={K} N={N}, map capacity P={P}, {n_live} "
          f"live points compacted into Q={Q}, iters {sa['iters']}, cg_iters "
          f"{sa['cg_iters']}")
    assert int(p.pt_valid.sum()) == n_live <= Q, (n_live, Q)
    assert P == bench_config(True).map_capacity.max_points, P
    ok0 = (p.obs_pt >= 0) & p.pt_valid[p.obs_pt.clamp(0, Q - 1).long()]
    live = int(ok0.sum())
    idx = ba.ba_point_index(p.obs_pt, ok0, Q)
    idx_r = ba.ba_point_index_plain(p.obs_pt, ok0, Q)
    same_idx = [bool(torch.equal(x, y)) for x, y in zip(idx, idx_r)]
    L = int(idx.offsets[-1])
    assert all(same_idx) and L == live, (same_idx, L, live)
    a = dict(kf_pose=p.kf_pose, pt_pos=p.pt_pos, p=p, obs_ok=ok0,
             cam=sa["cam"], use_huber=True, index=idx, w_obs=True)
    k = ba.ba_assemble(**a)
    k2 = ba.ba_assemble(**a)
    dense = ba.ba_assemble(**{**a, "w_obs": False})
    r = ba.ba_assemble_plain(**a)
    exact = ba.ba_assemble_plain(**{n: _f64(v) for n, v in a.items()})
    rows = idx.slots[:L].long()
    assert isinstance(k[3], ba.LiveRows) and k[3].index is idx
    k, r, exact = (list(k[:3]) + [k[3].rows[:L]], list(r[:3]) + [r[3][rows]],
                   list(exact[:3]) + [exact[3][rows]])
    same = all(torch.equal(x, y) for x, y in zip(k, list(k2[:3])
                                                  + [k2[3].rows[:L]]))
    as_dense = all(torch.equal(x, y) for x, y in zip(k[:3], dense[:3]))
    print(f"  K5 ba_assemble_w_obs K={K} N={N} Q={Q} live observations "
          f"{live}: (offsets, slots, place) equal to the plain index "
          f"{same_idx}; two calls bit-equal {same}; Hpp, g_p and Hll|g_l "
          f"bit-equal to the dense mode's {as_dense}")
    assert same and as_dense
    for name, x, y, z in zip(("Hpp", "g_p", "Hll|g_l", "W_obs live rows"),
                             k, r, exact):
        k5_agrees(name, x, y, z, cancels=name == "g_p")
    asm_err = max(float((x - y).abs().max()) for x, y in zip(k, r))
    del dense

    # the whole global BA with K5 and K6, its K6 calls recorded
    calls = []
    before = kernels.counts()
    with recording(calls, (ba, "ba_schur_cg")), cost_trace() as costs_k:
        res_k = ba.ba_solve(**sa)
    after = kernels.counts()
    gba_launches = {n: after[n] - before[n] for n in after
                    if after[n] != before[n]}
    it, cg = sa["iters"], sa["cg_iters"]
    print(f"  global BA launches: {json.dumps(gba_launches)}")
    assert gba_launches["ba_schur_cg"] == it == len(calls), gba_launches
    assert gba_launches["ba_assemble_w_obs"] == it, gba_launches
    k6_err = cg_readings(calls, device)

    # the whole global BA against the plain solve in f64 (deterministic
    # mode): the same LM schedule with every sum exact enough to be the
    # yardstick, as `cg_readings` holds each LM iteration's CG to it
    res_p, trace_p = plain_gba(sa)
    res_e, trace_e = plain_gba(sa, f64=True)
    # the control that must fail the gate: the plain solve on inputs
    # rounded to bf16 (`mantissa(v, 7)`)
    res_b, trace_b = plain_gba(sa, bits=7)
    trace_k = lm_trace(costs_k, sa.get("lambda0", 1e-4))
    for who, tr in (("kernel", trace_k), ("plain f32", trace_p),
                    ("plain f64", trace_e), ("bf16 inputs", trace_b)):
        print(f"  global BA LM iterations, {who}: " + ", ".join(
            f"{c:.10g} {a} lambda {lam:.3g}" for c, a, lam in tr))
    gaps = {"kernel vs f64": gba_gap(res_k, res_e, p),
            "plain f32 vs f64": gba_gap(res_p, res_e, p),
            "kernel vs plain f32": gba_gap(res_k, res_p, p),
            "bf16 inputs vs f64": gba_gap(res_b, res_e, p)}
    for who, g in gaps.items():
        print(f"  global BA {who}: rot {g[0]:.3g} rad trans {g[1]:.3g} m "
              f"points {g[2]:.3g} m, final costs {g[3]:.10g} / {g[4]:.10g}"
              f" (relative {abs(g[3] - g[4]) / g[4]:.3g}); within the gate "
              f"{gba_within(g)}")
    print(f"  global BA cost: kernel {float(res_k.initial_cost):.10g} -> "
          f"{float(res_k.final_cost):.10g}, f64 "
          f"{float(res_e.initial_cost):.10g} -> "
          f"{float(res_e.final_cost):.10g}")
    assert gba_within(gaps["kernel vs f64"]), gaps["kernel vs f64"]
    assert float(res_k.final_cost) < float(res_k.initial_cost)
    assert not gba_within(gaps["bf16 inputs vs f64"]), gaps

    # the pose-graph solve on the card against the CPU
    pg = dict(rec["pose_graph_solve"][0])
    out_d = pose_graph.pose_graph_solve(**pg)
    out_c = pose_graph.pose_graph_solve(**{
        **pg, "p": type(pg["p"])(*(t.cpu() for t in pg["p"]))})
    pd = float((out_d[0].cpu() - out_c[0]).abs().max())
    costs = [float(x) for x in (out_d[1], out_d[2], out_c[1], out_c[2])]
    E = pg["p"].edge_i.shape[0]
    print(f"  pose graph ({E} edges) on the card vs the CPU: poses "
          f"{pd:.3g}, cost {costs[0]:.6g} -> {costs[1]:.6g} (CPU "
          f"{costs[2]:.6g} -> {costs[3]:.6g})")
    assert pd <= 1e-3, pd
    for x, y in ((costs[0], costs[2]), (costs[1], costs[3])):
        assert abs(x - y) <= 1e-3 * max(abs(y), 1e-9), costs

    # what this call's data needs: obs_ok for every slot, the rest of an
    # observation (obs_pt, uv, ur, inv_s2) for the live slots only, a
    # point's rows (its position, G, w2) for the points that live slots
    # observe, and a keyframe's (Hpp_d, Minv, g_p) for the free keyframes
    # with a live slot
    S = K * N
    n_pts = int(torch.unique(p.obs_pt[ok0]).numel())
    n_kf = int((ok0.any(1) & ~p.kf_fixed).sum())
    asm = (asm_err,
           cuda_time_ms(lambda: ba.ba_assemble(**a), 20),
           cuda_time_ms(lambda: ba.ba_assemble_plain(**a), 5),
           # poses, observed points, obs_ok, live observations and the
           # index read; Hpp, g_p, the [Q,12] point rows and the live
           # W_obs rows written once
           K * 28 + n_pts * 12 + S + live * 20 + (Q + 1) * 4 + live * 4
           + K * 42 * 4 + Q * 48 + live * 72,
           # ~480 f32 a live observation (as the dense mode)
           {"f32": 480 * live})
    c0 = calls[0]
    c0_plain = {**c0, "W_obs": ba.w_obs_slot_rows(c0["W_obs"])}
    k6 = (k6_err,
          cuda_time_ms(lambda: ba.ba_schur_cg(**c0), 20),
          cuda_time_ms(lambda: ba.cg_solve_plain(**c0_plain), 3),
          # each input read once and each output written once: the live
          # rows, a slot's liveness (a byte, as obs_ok), `place`, obs_pt
          # and the slot of the live ones, the CSR's offsets, G and g_l of
          # the observed points, Hpp_d, Minv, g_p and free of the live
          # keyframes; dp and U^T dp written
          live * 72 + S + live * 4 * 3 + (Q + 1) * 4 + n_pts * (36 + 12)
          + n_kf * (144 + 144 + 24 + 1) + K * 24 + Q * 12,
          # a CG iteration: 36 FMAs a live slot (18 each way), G on the
          # observed points, Hpp_d p and Minv r (36 each a live keyframe),
          # ~10 vector operations an entry; the rhs and U^T dp (~18 a slot
          # each); a live slot's index steps, place and keyframe id
          {"f32": cg * (36 * live + 9 * n_pts + 72 * n_kf + 60 * n_kf)
           + 36 * live + 9 * live,
           "int32": cg * (4 * live + 2 * live) + 4 * live + 2 * live})
    print(f"  bounds count {live} live of {S} slots, {n_pts} observed of "
          f"{Q} point rows and {n_kf} live free of {K} keyframes")
    return asm, k6, calls, sa, pg, gba_launches


def profiled_solve(fn):
    """Device time, device operations and profiler rows of one call of a
    long solve (10^4-10^5 launches), one call a window, the card's
    activity only, and the operations each window counted. Such windows
    lose launches on the H100 (the pose graph's counted 74,273, 74,272 and
    71,552 operations in one run, 74,193, 74,271 and 73,197 in another),
    so the counts cannot be held equal: two windows are taken, a third
    when they differ, and the one that counted the most is returned, a
    lower bound of the device time by the share it lost."""
    seen = []
    for i in range(3):
        ops = []
        ms, rows = profiled_ms(fn, 1, ops, warm=i == 0, host_ops=False)
        seen.append((ops[0], ms, rows))
        if i == 1 and seen[0][0] == seen[1][0]:
            break
    best = max(seen, key=lambda x: x[0])
    counts = [x[0] for x in seen]
    print(f"  profiler windows of one call: {counts} device operations")
    return best[1], best[0], best[2], counts


def row_time_us(rows, key):
    """The device time a call (us) and launches a call of the profiler
    rows (as `profiled_ms` names them) whose name holds `key`."""
    us, n = 0.0, 0
    for r in rows:
        if key in r:
            us += float(r.split()[-2])
            n += int(r.split()[-3][1:])
    return us, n


def cg_barrier_ms(K, iters, reps=20):
    """Device time of K6's launch with every phase empty: the same grid,
    loop and 2 x iters + 1 grid barriers (`ba_schur_cg_barriers`)."""
    from orb_slam2_refactored_tpu_torch import kernels

    fn = kernels.bind("ba_schur", "ba_schur_cg_barriers",
                      [kernels.CI] * 2 + [kernels.VP])
    stream = torch.cuda.current_stream()

    def run():
        kernels.check(fn(K, iters, ctypes.c_void_p(stream.cuda_stream)),
                      "ba_schur_cg_barriers")
    ms, _ = profiled_ms(run, reps)
    return ms


def pose_graph_bound(pg):
    """B11's bound on the recorded pose-graph solve, counted from its
    shapes (`optim/pose_graph.py:73-151`): its inputs (poses, fixed flags,
    edges) read once and the poses and two costs written once, against
    the f32 operations that this run's edges (weight > 0) and live
    vertices (free keyframes that such an edge touches) need, an FMA one.
    An LM iteration: a residual (three Sim3 compositions or inverses and a
    log, ~260) and its two 7x7 Jacobian blocks (an adjoint product each,
    2 x 343) an edge, the weighted blocks (2 x 49), their gradient and
    Hessian terms (2 x (49 + 343)), the segment sums (2 x (7 + 49)) and the
    new cost (~274); a vertex's damping (14), 7x7 inverse (343), rhs,
    retraction and accept (~113). A CG iteration: J v and J^T (w J v)
    (4 x 49) and their segment sums (7 + 14) an edge; the damping and
    masks (21), Minv r (49) and the dot products and updates (35) a
    vertex."""
    from orb_slam2_refactored_tpu_torch.optim import pose_graph

    call = inspect.signature(pose_graph.pose_graph_solve).bind(**pg)
    call.apply_defaults()
    p, iters, cg = call.arguments["p"], call.arguments["iters"], \
        call.arguments["cg_iters"]
    K, E_all = p.poses.shape[0], p.edge_i.shape[0]
    live = p.edge_w > 0
    E = int(live.sum())
    touched = torch.zeros(K, dtype=torch.bool, device=p.poses.device)
    touched[p.edge_i[live].long()] = True
    touched[p.edge_j[live].long()] = True
    V = int((touched & ~p.fixed).sum())
    n_ops = iters * (E * (260 + 686 + 98 + 784 + 112 + 274)
                     + V * (14 + 343 + 113)
                     + cg * (E * (196 + 21) + V * (21 + 49 + 35)))
    nbytes = K * 32 + K + E_all * (4 + 4 + 32 + 4) + K * 32 + 8
    b_ms, b_by = bound_ms(nbytes, {"f32": n_ops})
    print(f"B11 pose_graph_solve bound ({E} live of {E_all} edges, {V} live "
          f"of {K} vertices, {iters} LM x {cg} CG): {b_ms:.6f} ms ({b_by}; "
          f"{nbytes} bytes, {n_ops} operations)")
    return b_ms, b_by, nbytes, n_ops


def gba_times(calls, sa, pg, asm_r, k6_r, reps=20):
    """Phase 5 for cell F's global BA: K6's device time a call (its one
    launch, and the whole call with the block-Jacobi inverse before it),
    its barrier floor (the same launch with empty phases, at 40 CG
    iterations and at none), K5's `w_obs` launch, then the whole global BA
    and the pose-graph solve, each with its device operations."""
    from orb_slam2_refactored_tpu_torch import kernels
    from orb_slam2_refactored_tpu_torch.optim import ba, pose_graph

    c0 = calls[0]
    K = c0["obs_pt"].shape[0]
    cg = c0["cg_iters"]
    ops = []
    call_ms, rows = profiled_ms(lambda: ba.ba_schur_cg(**c0), reps, ops)
    k6_us, k6_n = row_time_us(rows, "cg_kernel")
    k6_ms = k6_us / 1e3
    blocks = kernels.bind("ba_schur", "ba_schur_cg_blocks",
                          [kernels.CI])(K)
    print(f"K6 device time ba_schur_cg: {k6_ms:.5f} ms a launch ({blocks} "
          f"blocks, {cg} CG iterations); the whole call {call_ms:.5f} ms, "
          f"{ops[0]:g} device operations: {rows}")
    assert k6_n == 1, rows
    floor_ms = cg_barrier_ms(K, cg)
    floor0_ms = cg_barrier_ms(K, 0)
    print(f"K6 barrier floor: the launch with empty phases {floor_ms:.5f} ms "
          f"at {cg} CG iterations ({2 * cg + 1} grid barriers), "
          f"{floor0_ms:.5f} ms at none (1); "
          f"{(floor_ms - floor0_ms) / (2 * cg) * 1e3:.3f} us a barrier")
    sp = sa["p"]
    Q = sp.pt_pos.shape[0]
    ok0 = (sp.obs_pt >= 0) & sp.pt_valid[sp.obs_pt.clamp(0, Q - 1).long()]
    idx = ba.ba_point_index(sp.obs_pt, ok0, Q)
    ops = []
    asm_ms, rows = profiled_ms(lambda: ba.ba_assemble(
        sp.kf_pose, sp.pt_pos, sp, ok0, sa["cam"], True, index=idx,
        w_obs=True), reps, ops)
    print(f"K5 device time ba_assemble_w_obs: {asm_ms:.5f} ms a call, "
          f"{ops[0]:g} device operations: {rows}")
    assert ops[0] == 1, rows
    gba_ms, gba_ops, rows, gba_win = profiled_solve(
        lambda: ba.ba_solve(**sa))
    hosts = []
    for _ in range(3):
        t0 = time.perf_counter()
        ba.ba_solve(**sa)
        torch.cuda.synchronize()
        hosts.append((time.perf_counter() - t0) * 1e3)
    print(f"global BA (K={K}, Q={Q}, {sa['iters']} LM x {cg} CG): device "
          f"time {gba_ms:.4f} ms, {gba_ops:g} device operations, host clock "
          f"{hosts} ms; top rows: "
          f"{sorted(rows, key=lambda x: -float(x.split()[-2]))[:6]}")
    pg_ms, pg_ops, rows, pg_win = profiled_solve(
        lambda: pose_graph.pose_graph_solve(**pg))
    t0 = time.perf_counter()
    pose_graph.pose_graph_solve(**pg)
    torch.cuda.synchronize()
    pg_host = (time.perf_counter() - t0) * 1e3
    print(f"pose-graph solve ({pg['p'].edge_i.shape[0]} edges, 20 LM x 50 "
          f"CG): device time {pg_ms:.4f} ms, {pg_ops:g} device operations, "
          f"host clock {pg_host:.2f} ms; top rows: "
          f"{sorted(rows, key=lambda x: -float(x.split()[-2]))[:4]}")
    pg_bound = pose_graph_bound(pg)
    for name, r, ms in (("K6", k6_r, k6_ms), ("K5 w_obs", asm_r, asm_ms)):
        b_ms, b_by = bound_ms(r[3], r[4])
        print(f"{name} bound {b_ms:.6f} ms ({b_by}; {r[3]} bytes, "
              f"{json.dumps(r[4])} operations); device time {ms:.5f} ms "
              f"({ms / b_ms:.1f}x)")
    return (asm_r + (asm_ms,), k6_r + (k6_ms,),
            {"gba_device_ms": gba_ms, "gba_device_ops": gba_ops,
             "gba_window_ops": gba_win, "gba_host_ms": hosts,
             "k6_call_device_ms": call_ms, "k6_blocks": blocks,
             "k6_barrier_floor_ms": floor_ms,
             "k6_barrier_floor_0_ms": floor0_ms,
             "pose_graph_device_ms": pg_ms, "pose_graph_device_ops": pg_ops,
             "pose_graph_window_ops": pg_win,
             "pose_graph_host_ms": pg_host, "pose_graph_bound_ms": pg_bound[0],
             "pose_graph_bound_by": pg_bound[1]})


# ---------------------------------------------------------------------------
# the monocular slice: cells G and H, the solvers on the card, C11
# ---------------------------------------------------------------------------

MONO_ATE_M = 0.35  # bench.py:696-697, the mono probe's sim3 sanity bar
MONO_LOOP_ATE_M = 0.45  # tests/test_mono_loop.py's sim3 gate
MONO_CIRCUIT_FRAMES = 240
# the live points K5's point index held before its counts could move to
# global memory (C11)
OLD_INDEX_LIMIT = 27904


def mono_config(**kw):
    """`bench.py:663-670`'s mono probe: the bench's VGA configuration with
    bf = 0 and `kf_ref_ratio=0.9`, local BA on; synchronous (the bench's
    pipelined probe is phase 3m's G-pipe)."""
    import dataclasses

    return dataclasses.replace(bench_config(True), bf=0.0, kf_ref_ratio=0.9,
                               **kw)


def mono_launch_gates(launches, tag, loop_closed=False):
    """Every kernel of the mono path launched; B9 never; the global BA's
    only where a loop closed."""
    for k, v in launches.items():
        if k in ("stereo_sad", LEARNED_KERNEL, LARGE_KERNEL,
                 WIRE_KERNEL) + SHARDED_KERNELS:
            assert v == 0, f"{k} launched on {tag}"
        elif k in LOOP_KERNELS:
            assert (v > 0) == loop_closed, (k, v, tag)
        else:
            assert v > 0, f"kernel {k} never launched on {tag}"


def run_mono_orbit(imgs, gt, device, depth=0, uploaded=False):
    """Cell G: the bench's orbit through `Tracker.track_mono` twice, a
    warm-up lap (which initializes) and a measured lap, as the bench's mono
    probe runs it, every launch counter set to 0 just before the first lap
    and read after the second. On the frame that initializes, its K1 calls
    (the 100 px window match, both passes), its `initialize` call and the
    bootstrap BA's first `ba_assemble` and its `ba_solve` are recorded.
    Gates: OK at the end, >= 2 keyframes, sim3 ATE of the measured lap
    under MONO_ATE_M. `depth` > 0 runs it pipelined with that many frames
    in flight; `uploaded` packs and uploads the lap's images once on the
    tracker's pool (`prefetch_mono`, phase 3p) and steps them through
    `track_mono_uploaded`, as the bench's mono probe does."""
    from orb_slam2_refactored_tpu_torch import kernels
    from orb_slam2_refactored_tpu_torch.io.evaluation import ate_rmse
    from orb_slam2_refactored_tpu_torch.optim import ba
    from orb_slam2_refactored_tpu_torch.slam import local_mapping, tracking
    from orb_slam2_refactored_tpu_torch.utils.timing import StageTimer

    tracker = tracking.Tracker(pipelined(mono_config(), depth),
                               device=device)
    timer = StageTimer(device)
    n = len(imgs)
    boot = None
    kf_made = []
    kernels.reset_counts()
    t0 = time.perf_counter()
    bufs = ([f.result() for f in tracker.prefetch_mono(imgs)] if uploaded
            else None)
    for lap in range(2):
        for j in range(n):
            cur = {"k1": [], "init": [], "asm": [], "solve": []}
            with contextlib.ExitStack() as st:
                if tracker.state == tracking.TrackState.NOT_INITIALIZED:
                    st.enter_context(recording_k1(cur["k1"]))
                    st.enter_context(recording(cur["init"],
                                               (tracking, "initialize")))
                    st.enter_context(recording(cur["asm"],
                                               (ba, "ba_assemble")))
                    st.enter_context(recording(
                        cur["solve"], (local_mapping, "ba_solve")))
                kf_made.append(timed_frame(timer, tracker, partial(
                    tracker.track_mono_uploaded, bufs[j],
                    timestamp=(lap * n + j) / 30.0) if uploaded else partial(
                    tracker.track_mono, imgs[j],
                    timestamp=(lap * n + j) / 30.0)))
            if cur["init"] and tracker.state == tracking.TrackState.OK:
                boot = cur
        tracker.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.counts()
    est = np.stack(tracker.trajectory[-n:])
    assert est.shape == gt.shape and np.isfinite(est).all()
    ate, _ = ate_rmse(est, gt, align="sim3")
    steps = np.asarray(timer.samples["step"][n:])
    lap2 = step_stats(timer.samples["step"][n:], kf_made[n:], tracker,
                      warmup=0)
    init_frame = next(i for i, e in enumerate(tracker.traj_entries)
                      if not e["lost"])
    stats = {
        "cell": "G", "frames": 2 * n, "ate_sim3_m": ate,
        "state": int(tracker.state), "init_frame": init_frame,
        "lost_frames": sum(1 for t in tracker.track_info if t.get("lost")),
        "ref_fallbacks": sum(1 for t in tracker.track_info
                             if t.get("ref_fallback")),
        "keyframes_alive": len(tracker.graph.alive_kfs()),
        "window_ba_solves": tracker.local_mapper.n_ba,
        "map_points_alive": int(tracker.graph.pt_alive.sum()),
        "fps_measured_lap": float(n / steps.sum()),
        **lap2,
        "wall_s": wall, "launches": launches}
    mode = (f", pipelined depth {depth}" if depth else "") + (
        ", prefetch_mono" if uploaded else "")
    print(f"cell G (mono orbit{mode}) " + json.dumps(stats))
    print(f"keyframe stages ({stage_clock(tracker)}):")
    for line in tracker.timer.report().splitlines():
        print("  " + line)
    assert stats["state"] == 1, tracker.track_info[-3:]
    assert stats["keyframes_alive"] >= 2, stats
    assert ate < MONO_ATE_M, f"cell G: sim3 ATE {ate} m"
    mono_launch_gates(launches, "cell G")
    # one extraction a frame, whatever the frame's branch
    assert launches["fast"] == launches["orb_desc"] == 2 * n, launches
    extraction_launches(launches, 2 * n, "cell G")
    assert boot is not None and len(boot["init"]) == 1, "no bootstrap"
    N = tracker.cfg.n_features
    window = [a for a in boot["k1"] if "pair_ok" in a]
    assert len(window) == 2 and all(
        a["pair_ok"].shape == (N, N) for a in window), len(window)
    assert boot["asm"] and len(boot["solve"]) == 1
    return stats, tracker, boot


def mono_circuit_frames():
    """Cell H: `tests/test_mono_loop.py`'s scenario: 240 QVGA views of
    `circuit_trajectory(240, overlap=40)` in the box room 1.7 x 1.3 x 2.7
    with distinct textures (f32 images, rounded as the JAX package's
    `_pack_mono` rounds them)."""
    from orb_slam2_refactored_tpu_torch.io.synthetic import (
        SyntheticScene, box_room)

    gt = circuit_trajectory(MONO_CIRCUIT_FRAMES, overlap=40)
    scene = SyntheticScene(width=320, height=240, fx=260.0, fy=260.0,
                           planes=box_room(1.7, 1.3, 2.7, -2.7,
                                           distinct_textures=True))
    return [scene.render(pose)[0] for pose in gt], gt


def mono_circuit_config():
    """Cell H: `tests/test_mono_loop.py`'s configuration (900 features, 4
    levels, 1024 words, a keyframe at least every 8 frames, `MapCapacity(
    96, 16384, 900)`, loop closing on, bf = 0)."""
    from orb_slam2_refactored_tpu_torch.slam.map_state import MapCapacity
    from orb_slam2_refactored_tpu_torch.slam.tracking import TrackerConfig

    return TrackerConfig(
        width=320, height=240, fx=260.0, fy=260.0, cx=160.0, cy=120.0,
        bf=0.0, n_features=900, n_levels=4, enable_loop_closing=True,
        vocab_words=1024, kf_max_interval=8,
        map_capacity=MapCapacity(max_keyframes=96, max_points=16384,
                                 max_features=900))


def run_mono_circuit(frames, gt, device):
    """Cell H (`mono_circuit_config`) through `track_mono`, every launch
    counter set to 0 just before and read just after. Gates (JAX's own):
    OK at the end, a loop closed (an implicit one verified by >= 25
    projected matches), sim3 ATE of `corrected_frame_poses` under
    MONO_LOOP_ATE_M. The Sim3 of a mono loop has a free scale."""
    from orb_slam2_refactored_tpu_torch import kernels
    from orb_slam2_refactored_tpu_torch.io.evaluation import ate_rmse
    from orb_slam2_refactored_tpu_torch.slam.system import (
        corrected_frame_poses)
    from orb_slam2_refactored_tpu_torch.slam.tracking import Tracker

    tracker = Tracker(mono_circuit_config(), device=device)
    real = tracker._close_loop

    def close_loop(*a, **k):
        with tracker.timer.time("loop.close_loop"):
            return real(*a, **k)

    tracker._close_loop = close_loop
    kernels.reset_counts()
    t0 = time.perf_counter()
    for i, img in enumerate(frames):
        tracker.track_mono(img, timestamp=i / 30.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.counts()
    tracker.flush()
    est = corrected_frame_poses(tracker)
    assert est.shape == gt.shape and np.isfinite(est).all()
    ate, _ = ate_rmse(est, gt, align="sim3")
    lc, info = tracker.loop_closer, tracker.last_loop_info
    samples = tracker.timer.samples
    # the views lost after the bootstrap (mid-run losses that
    # relocalization recovers are in JAX's gates)
    ok = [not e["lost"] for e in tracker.traj_entries]
    lost = [i for i in range(ok.index(True), len(ok)) if not ok[i]]
    stats = {
        "cell": "H", "frames": len(frames), "ate_sim3_m": ate,
        "loops_closed": lc.loops_closed if lc else 0,
        "state": int(tracker.state), "lost_frames": len(lost),
        "lost_views_first_last": lost[:1] + lost[-1:],
        "keyframes_alive": len(tracker.graph.alive_kfs()),
        "map_points_alive": int(tracker.graph.pt_alive.sum()),
        "last_loop_info": None if info is None else {
            k: (list(v) if isinstance(v, tuple) else v)
            for k, v in info.items()},
        "close_loop_ms": [x * 1e3 for x in samples.get("loop.close_loop",
                                                      [])],
        "gba_merge_ms": [x * 1e3 for x in samples.get("kf.gba_merge", [])],
        "wall_s": wall, "launches": launches}
    print("cell H (mono circuit, loop closing on) " + json.dumps(stats))
    assert stats["state"] == 1, tracker.track_info[-3:]
    assert stats["loops_closed"] >= 1, "cell H: no loop closed"
    if info.get("implicit"):
        assert info["n_proj"] >= 25, info
    assert ate < MONO_LOOP_ATE_M, f"cell H: sim3 ATE {ate} m"
    mono_launch_gates(launches, "cell H", loop_closed=True)
    extraction_launches(launches, len(frames), "cell H")
    return stats


def check_mono_fallback(imgs, gt, device, n=12):
    """The mono step's other branch on the card: with `min_matches_mm` out
    of reach every tracked frame takes the reference-keyframe fallback,
    which in mono seeds its LM with `pnp_ransac`. Returns the `pnp_ransac`
    and K4 calls of its last frame."""
    from orb_slam2_refactored_tpu_torch.io.evaluation import ate_rmse
    from orb_slam2_refactored_tpu_torch.slam import tracking

    tracker = tracking.Tracker(mono_config(min_matches_mm=10 ** 6),
                               device=device)
    for i in range(n - 1):
        tracker.track_mono(imgs[i])
    pnp, k4 = [], []
    with recording(pnp, (tracking, "pnp_ransac")), recording_k4(k4):
        tracker.track_mono(imgs[n - 1])
    info = [t for t in tracker.track_info if "ref_fallback" in t]
    ate, _ = ate_rmse(np.stack(tracker.trajectory), gt[:n], align="sim3")
    print(f"mono fallback branch: {n} frames, {len(info)} tracked, all by "
          f"the fallback: {all(t['ref_fallback'] for t in info)}, sim3 ATE "
          f"{ate:.4f} m")
    assert not any(t.get("lost") for t in tracker.track_info)
    # every frame after the bootstrap tracked, each through the fallback
    assert len(info) >= n // 2 and all(t["ref_fallback"] for t in info)
    assert len(pnp) == 1 and ate <= MONO_ATE_M, (len(pnp), ate)
    return pnp[0], k4


def record_tracked_mono_frame(tracker, imgs):
    """The K1 and K4 calls of one more mono frame tracked after cell G."""
    k1, k4 = [], []
    with recording_k1(k1), recording_k4(k4):
        tracker.track_mono(imgs[0])
    info = tracker.track_info[-1]
    assert not info.get("lost") and not info.get("ref_fallback"), info
    assert all(bool((a["obs_ur"] <= 0).all()) for a in k4), "a stereo row"
    return k1, k4


def _cpu(a):
    return {n: v.cpu() if isinstance(v, torch.Tensor) else v
            for n, v in a.items()}


def _rot_dir_err(p, q):
    """(rotation rad, translation direction rad) of pose p against q."""
    from orb_slam2_refactored_tpu_torch.geometry import se3

    p, q = p.cpu(), q.cpu()
    rot = float(se3.log(se3.compose(p, se3.inverse(q)))[:3].norm())
    # the angle between the translations, in f64 and from both its sine
    # and cosine (an f32 acos near 1 reads 3e-4 for equal vectors)
    a, b = se3.translation(p).double(), se3.translation(q).double()
    return rot, math.atan2(float(torch.linalg.cross(a, b).norm()),
                           float(a @ b))


def init_winners(a):
    """The initializer's winning H and F hypotheses on call `a`."""
    from orb_slam2_refactored_tpu_torch.solvers import initializer as ini

    xn1, T1 = ini._normalize(a["x1"], a["valid"])
    xn2, T2 = ini._normalize(a["x2"], a["valid"])
    s = a["samples"]
    Hs = torch.linalg.inv(T2) @ ini._compute_h(xn1[s], xn2[s]) @ T1
    Fs = T2.T @ ini._compute_f(xn1[s], xn2[s]) @ T1
    sh, _ = ini._score_h(Hs, a["x1"], a["x2"], a["valid"])
    sf, _ = ini._score_f(Fs, a["x1"], a["x2"], a["valid"])
    return int(torch.argmax(sh)), int(torch.argmax(sf))


def pnp_winner(a):
    """`pnp_ransac`'s winning hypothesis on call `a` (its samples given)."""
    from orb_slam2_refactored_tpu_torch.solvers import ransac

    s, half = a["samples"], a["samples"].shape[0] // 2
    xn = ransac._normalized(a["cam"], a["uv"])
    poses = torch.cat([ransac._dlt_resection(a["pts3d"][s[:half]],
                                             xn[s[:half]]),
                       ransac._planar_resection(a["pts3d"][s[half:]],
                                                xn[s[half:]])])
    e2, inl = ransac._reproj(a["cam"], poses, a["pts3d"], a["uv"],
                             a["valid"], a.get("inlier_th_px", 9.0))
    n = inl.sum(-1)
    score = n.float() - torch.where(inl, e2, torch.zeros_like(e2)).sum(-1) \
        / n.clamp(min=1) / a.get("inlier_th_px", 9.0)
    return int(torch.argmax(score))


def check_solvers(init_call, pnp_call):
    """The card's `initialize` (cell G's bootstrap call) and `pnp_ransac`
    (the mono fallback's call, its samples drawn once and passed to both)
    against the same function on the CPU: the same success, model and
    winning hypotheses; the pose within 1e-3 rad and 1e-3 rad of
    translation direction."""
    from orb_slam2_refactored_tpu_torch.solvers import initializer, ransac

    out = {}
    a = dict(init_call)
    d, c = initializer.initialize(**a), initializer.initialize(**_cpu(a))
    wins = (init_winners(a), init_winners(_cpu(a)))
    rot, ang = _rot_dir_err(d.pose21, c.pose21)
    good = float((d.is_good.cpu() == c.is_good).float().mean())
    print(f"  initialize on the card vs the CPU: success {bool(d.success)} / "
          f"{bool(c.success)}, homography {bool(d.used_homography)} / "
          f"{bool(c.used_homography)}, winning (H, F) {wins[0]} / {wins[1]}, "
          f"rotation {rot:.3g} rad, translation direction {ang:.3g} rad, "
          f"is_good equal {good:.4f}")
    assert bool(d.success) == bool(c.success) is True
    assert bool(d.used_homography) == bool(c.used_homography)
    assert wins[0] == wins[1] and rot <= 1e-3 and ang <= 1e-3
    out["initialize"] = max(rot, ang)
    p = dict(pnp_call)
    gen = torch.Generator(device=p["pts3d"].device).manual_seed(0)
    p["samples"] = ransac.draw_samples(p["valid"], p.get("n_iters", 256),
                                       p.get("sample_size", 8), gen)
    p.pop("generator", None)
    d, c = ransac.pnp_ransac(**p), ransac.pnp_ransac(**_cpu(p))
    wins = (pnp_winner(p), pnp_winner(_cpu(p)))
    rot, ang = _rot_dir_err(d.pose, c.pose)
    print(f"  pnp_ransac on the card vs the CPU ({int(p['valid'].sum())} "
          f"matches): success {bool(d.success)} / {bool(c.success)}, "
          f"inliers {int(d.n_inliers)} / {int(c.n_inliers)}, winning "
          f"hypothesis {wins[0]} / {wins[1]}, rotation {rot:.3g} rad, "
          f"translation direction {ang:.3g} rad")
    assert bool(d.success) == bool(c.success) is True
    assert wins[0] == wins[1] and rot <= 1e-3 and ang <= 1e-3
    out["pnp_ransac"] = max(rot, ang)
    return out, p


def full_map_ba_problem(device, K=128, N=1000, P=32768, n_live=30000,
                        seed=5):
    """A global-BA problem at the bench's map capacity (P = 32768) with
    more live points than the point index held before (27,904): K cameras
    along a line, each point seen by 2-5 neighbouring keyframes (mono
    rows, 0.5 px noise), the first two keyframes fixed, poses and points
    perturbed."""
    from orb_slam2_refactored_tpu_torch.geometry import se3
    from orb_slam2_refactored_tpu_torch.optim import ba

    rng = np.random.default_rng(seed)
    cam = bench_cam()
    cx = 0.05 * np.arange(K)
    ids = np.sort(rng.permutation(P)[:n_live])
    home = rng.integers(0, K, n_live)
    per = rng.integers(2, 6, n_live)
    pts = np.zeros((P, 3), np.float32)
    pts[ids] = np.stack([cx[home] + rng.uniform(-1.2, 1.2, n_live),
                         rng.uniform(-1.2, 1.2, n_live),
                         rng.uniform(3, 7, n_live)], -1)
    kf = np.concatenate([np.clip(home[i] + np.arange(per[i]) - per[i] // 2,
                                 0, K - 1) for i in range(n_live)])
    pt = np.repeat(ids, per)
    kf, first = np.unique(kf * P + pt, return_index=True)
    kf, pt = kf // P, pt[first]
    order = rng.permutation(len(kf))
    kf, pt = kf[order], pt[order]
    slot = np.zeros(len(kf), np.int64)
    for k in range(K):  # each keyframe's observations take its first slots
        sel = np.nonzero(kf == k)[0]
        slot[sel] = np.arange(len(sel))
    keep = slot < N
    kf, pt, slot = kf[keep], pt[keep], slot[keep]
    obs_pt = np.full((K, N), -1, np.int32)
    obs_pt[kf, slot] = pt
    xc = pts[pt] - np.stack([cx[kf], np.zeros(len(kf)), np.zeros(len(kf))],
                            -1)
    uv = np.zeros((K, N, 2), np.float32)
    uv[kf, slot] = (np.stack([cam.fx * xc[:, 0] / xc[:, 2] + cam.cx,
                              cam.fy * xc[:, 1] / xc[:, 2] + cam.cy], -1)
                    + rng.normal(0, 0.5, (len(kf), 2)))
    poses = np.zeros((K, 7), np.float32)
    poses[:, 0] = 1.0
    poses[:, 4] = -cx
    t = lambda x: torch.as_tensor(x, device=device)
    kf_pose = se3.retract(t(poses), t(rng.normal(0, 0.005, (K, 6))
                                      .astype(np.float32)))
    kf_pose[:2] = t(poses[:2])
    valid = np.zeros(P, bool)
    valid[ids] = True
    valid &= np.bincount(obs_pt[obs_pt >= 0], minlength=P) >= 2
    fixed = np.zeros(K, bool)
    fixed[:2] = True
    noisy = pts + rng.normal(0, 0.02, pts.shape).astype(np.float32)
    return ba.BAProblem(
        kf_pose=kf_pose, kf_fixed=t(fixed), obs_uv=t(uv),
        obs_ur=t(-np.ones((K, N), np.float32)), obs_pt=t(obs_pt),
        obs_inv_s2=t(np.ones((K, N), np.float32)), pt_pos=t(noisy),
        pt_valid=t(valid), pt_frozen=None), cam


def check_full_map_ba(device):
    """C11 on the card: a global BA at P = 32768 with more than 27,904 live
    points. `compact_points` keeps every live point (padded to the
    bucket), K5's index (past its shared-memory rows: counts in global
    memory) equals the plain index, and one LM iteration's `ba_schur_cg`
    meets the f64 CG yardstick (`cg_yardstick`)."""
    from orb_slam2_refactored_tpu_torch.optim import ba

    t0 = time.perf_counter()
    full, cam = full_map_ba_problem(device)
    n_live = int(full.pt_valid.sum())
    p, live = ba.compact_points(full)
    Q = p.pt_pos.shape[0]
    assert n_live > OLD_INDEX_LIMIT and live.numel() == n_live, (
        n_live, live.numel())
    assert Q % ba.POINT_BUCKET == 0 and n_live <= Q < n_live + \
        ba.POINT_BUCKET, Q
    ok0 = (p.obs_pt >= 0) & p.pt_valid[p.obs_pt.clamp(0, Q - 1).long()]
    idx = ba.ba_point_index(p.obs_pt, ok0, Q)
    idx_r = ba.ba_point_index_plain(p.obs_pt, ok0, Q)
    same = [bool(torch.equal(x, y)) for x, y in zip(idx, idx_r)]
    again = all(torch.equal(x, y) for x, y in zip(
        idx, ba.ba_point_index(p.obs_pt, ok0, Q)))
    calls = []
    with recording(calls, (ba, "ba_schur_cg")):
        res = ba.ba_solve(p, cam, iters=1, cg_iters=40, dense_schur=False)
    c = calls[0]
    out = ba.ba_schur_cg(**c)
    yard, _, _ = cg_yardstick({"kernel": out}, {
        **c, "W_obs": ba.w_obs_slot_rows(c["W_obs"])})
    reads = {}
    for name in ("dp", "ut"):
        e_k, e_p, scale = yard[f"kernel {name}"]
        reads[name] = e_k / (CG_FACTOR * e_p + CG_FLOOR * scale)
    print(f"  C11 global BA at P={full.pt_pos.shape[0]}: {n_live} live points "
          f"kept in Q={Q}, {int(ok0.sum())} live slots; point index equal to "
          f"the plain one {same}, two builds bit-equal {again}; one LM "
          f"iteration's ba_schur_cg against the f64 yardstick {json.dumps(reads)} "
          f"of the bound; cost {float(res.initial_cost):.6g} -> "
          f"{float(res.final_cost):.6g}; {time.perf_counter() - t0:.1f} s")
    assert all(same) and again, same
    assert max(reads.values()) <= 1.0, reads
    assert float(res.final_cost) < float(res.initial_cost)
    return reads


def svd_flops(m, n):
    """The operations of an SVD of an m x n matrix with its V (R-SVD,
    Golub and Van Loan, Matrix Computations, 4th ed., table 8.6.1:
    4 m n^2 + 8 n^3 for the singular values and V; m < n as its
    transpose)."""
    m, n = max(m, n), min(m, n)
    return 4 * m * n * n + 8 * n ** 3


def init_bound(a):
    """Bytes and operations of one `initialize` call on this run's data:
    200 [16, 9] and 200 [8, 9] SVDs with their 3 x 3 projections, both
    models scored on the valid matches (~70 f32 a match for H's two
    transfers, ~50 for F's two lines), then the 12 motions checked on the
    inliers (a [4, 4] SVD and ~120 f32 a point each)."""
    S = a["samples"].shape[0]
    M = a["x1"].shape[0]
    n_v = int(a["valid"].sum())
    ops = S * (svd_flops(16, 9) + svd_flops(8, 9) + svd_flops(3, 3) + 200)
    ops += S * n_v * (70 + 50) + 12 * n_v * (svd_flops(4, 4) + 120)
    # x1, x2, valid and the samples read; pose, points, flags written
    nbytes = M * 17 + S * 8 * 8 + 28 + M * 13 + 1
    return nbytes, {"f32": ops}


def pnp_bound(a, n_inl):
    """Bytes and operations of one `pnp_ransac` call on this run's data:
    128 [16, 12] and 128 [16, 9] SVDs with their 3 x 3 rotations (and a
    3 x 3 eigh a planar sample), the 256 poses scored on the valid matches
    (~40 f32 a match: transform, projection, error), the two refits on the
    winner's inliers and their scores."""
    S = a["samples"].shape[0]
    M = a["pts3d"].shape[0]
    n_v = int(a["valid"].sum())
    ops = (S // 2) * (svd_flops(16, 12) + svd_flops(16, 9)
                      + 2 * svd_flops(3, 3) + 400)
    ops += (S + 2) * n_v * 40
    ops += svd_flops(2 * n_inl, 12) + svd_flops(2 * n_inl, 9) \
        + 2 * svd_flops(3, 3)
    nbytes = M * (12 + 8 + 1) + S * 8 * 8 + 28 + M + 8
    return nbytes, {"f32": ops}


def mono_times(init_call, pnp_call, frame_bytes, frame_ops):
    """Phase 5 for the mono slice: the initializer's population and
    `pnp_ransac` (device time and operations from torch.profiler, the host
    clock of a synchronized call, the bound from their shapes), and the
    bound of the work of a tracked mono frame's kernels."""
    from orb_slam2_refactored_tpu_torch.solvers import initializer, ransac

    out = {}
    for name, fn, (nb, ops) in (
            ("initialize", lambda: initializer.initialize(**init_call),
             init_bound(init_call)),
            ("pnp_ransac", lambda: ransac.pnp_ransac(**pnp_call),
             pnp_bound(pnp_call, int(ransac.pnp_ransac(
                 **pnp_call).n_inliers)))):
        # ~750 launches a call: one call a window (`profiled_solve`)
        ms, n_ops, rows, _ = profiled_solve(fn)
        host = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        b_ms, b_by = bound_ms(nb, ops)
        out[name] = {"device_ms": ms, "device_ops": n_ops,
                     "host_ms_median": float(np.median(host)),
                     "card_ms": cuda_time_ms(fn, 10), "bound_ms": b_ms,
                     "bound_by": b_by}
        src = ("cell G's bootstrap call" if name == "initialize"
               else "the mono fallback's call")
        print(f"{name} ({src}): {json.dumps(out[name])}")
        for r in rows[:8]:
            print(f"  {r}")
    b_ms, b_by = bound_ms(frame_bytes, frame_ops)
    print(f"cell G tracked mono frame: bound of its kernels' work "
          f"{b_ms:.6f} ms ({b_by})")
    out["frame_bound_ms"] = b_ms
    return out


# B6's parameters among `search_by_projection_with_vis`'s
B6_ARGS = ("mp_pos", "mp_desc", "mp_normal", "mp_min_dist", "mp_max_dist",
           "mp_valid", "pose_cw", "cam", "scale_factors", "radius",
           "check_view_angle", "image_bounds", "candidate_cap")


def _same_bits(a, b):
    """Equal values, f32 compared by their bits (NaN included), int32 and
    int64 indices by value."""
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    if a.dtype in (torch.int32, torch.int64):
        return torch.equal(a.long(), b.long())
    return torch.equal(a, b)


def b6_work(a):
    """(bytes, operations) of B6 on a search's arguments `a`: each point's
    position, normal, distances and validity read (33 bytes) and its
    visibility and row written (5); each row's descriptor read and its
    (uv, radius, level, ok, descriptor, point) written (32 + 53); ~100 f32
    operations a point (the transform's 27, the projection, the gates, the
    distance, the level's log and divisions, the view angle, the radius)
    and ~10 int32 ones (the ballots and the placement)."""
    P = a["mp_pos"].shape[0]
    cap = a.get("candidate_cap", 8192)
    R = cap if cap and cap < P else P
    return P * 38 + R * 85, {"f32": 100 * P, "int32": 10 * P}


def r_work(a):
    """(bytes, operations) of R on the arguments `a` of
    `resolve_duplicates` (M rows: target, distance, validity read, the
    keep byte written), of `resolve_rows` (and the kept index written) or
    of `resolve_to_points` (and the P points' slot read and (idx, best,
    keep) written); ~10 int32 operations a row and a point."""
    M = a["target_idx"].shape[0]
    P = a["slot"].shape[0] if "slot" in a else 0
    out = P * 13 if P else M * (5 if "max_dist" in a else 1)
    return M * 9 + out, {"int32": 10 * (M + P)}


def r_entry(a, plain=False):
    """R's entry for recorded arguments `a` (`resolve_to_points` where
    they hold `slot`, `resolve_rows` where they hold `max_dist`, else
    `resolve_duplicates`), or its plain version."""
    from orb_slam2_refactored_tpu_torch.ops import hamming

    name = ("resolve_to_points" if "slot" in a else "resolve_rows"
            if "max_dist" in a else "resolve_duplicates")
    return getattr(hamming, name + "_plain" * plain)


def features_args(a):
    """B6's feature-mode arguments (`project_features`) of a recorded
    `search_last_frame_mapped` call `a`."""
    return dict(pos=a["mp_pos"], level=a["last_level"], pose_cw=a["pose_cw"],
                cam=a["cam"], scale_factors=a["scale_factors"],
                radius=a.get("radius", 7.0), feat_idx=a["last_mp"],
                pos_valid=a["mp_valid"])


def features_work(a):
    """(bytes, operations) of B6's feature mode on a recorded motion-model
    call `a`: each feature's point id and level read (8 bytes), its map
    point's position and validity (13) and its (uv, radius, ok) written
    (13); ~45 f32 operations a feature (the transform's 27, the
    projection, the radius) and ~6 int32 ones (the clamp, the gates)."""
    N = a["last_mp"].shape[0]
    return N * 34, {"f32": 45 * N, "int32": 6 * N}


def host_us(fn, reps=1000):
    """Host microseconds a call of `fn` (its wrapper's time: the launches
    are enqueued, nothing waits for the card), over `reps` calls after a
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def check_motion_model(cases, per_frame):
    """Phase 4: B6's feature mode against its plain version bit for bit on
    the motion-model searches the main paths made (a tracked frame's of
    cells A, C and G: each feature's uv, radius and ok); on K1's output
    for its rows, R's rows mode against its plain version; and the whole
    search (B6's feature mode, K1, R: three launches) against
    `search_last_frame_mapped_plain`. The `per_frame` call (cell A's) is
    timed with CUDA events, its bound counted from its shapes. Returns the
    feature mode's (error, ms, plain ms, bytes, operations) on it."""
    from orb_slam2_refactored_tpu_torch import kernels
    from orb_slam2_refactored_tpu_torch.ops import hamming, matching

    row = None
    for name, a in cases.items():
        fa = features_args(a)
        got = [x.clone() for x in matching.project_features(**fa)]
        ref = matching.project_features_plain(**fa)
        torch.cuda.synchronize()
        bad = [f for f, x, y in zip(("uv", "rad", "ok"), got, ref)
               if not _same_bits(x, y)]
        idx, best, _ = hamming.masked_best2_gated(
            a["last_desc"], a["curr_desc"], got[2], a["curr_valid"], got[0],
            got[1], a["last_level"], a["curr_xy"], a["curr_level"])
        rr = dict(target_idx=idx, dist=best, valid=got[2],
                  max_dist=a.get("max_dist", hamming.TH_HIGH),
                  n_targets=a["curr_desc"].shape[0])
        r_same = all(torch.equal(x, y) for x, y in zip(
            hamming.resolve_rows(**rr), hamming.resolve_rows_plain(**rr)))
        before = kernels.counts()
        out = matching.search_last_frame_mapped(**a)
        after = kernels.counts()
        launches = {k: after[k] - before[k] for k in after
                    if after[k] != before[k]}
        ref_out = matching.search_last_frame_mapped_plain(**a)
        whole = all(torch.equal(x, y) for x, y in zip(out, ref_out))
        print(f"  B6 features {name}: {a['last_mp'].shape[0]} features, "
              f"{int(ref[2].sum())} passing, {int(out.valid.sum())} "
              f"matched; fields that differ {bad}; R (rows mode) equal "
              f"{r_same}; the search's launches {launches}, equal to the "
              f"plain search {whole}")
        assert not bad and r_same and whole, name
        assert launches == {"project_features": 1, "hamming_best2": 1,
                            "resolve_claims": 1}, launches
        if name == per_frame:
            nbytes, ops = features_work(a)
            row = (0, cuda_time_ms(lambda: matching.project_features(**fa),
                                   50),
                   cuda_time_ms(lambda: matching.project_features_plain(
                       **fa), 10), nbytes, ops)
    return row


def check_project_search(cases, per_frame):
    """Phase 4: B6 against its plain version bit for bit on the projection
    searches the main paths made (each row's uv, radius, level, ok,
    descriptor and point, each point's visibility and row); then, on K1's
    output for B6's rows, R in its projection mode against its plain
    version, and the whole search (B6, K1, R) against
    `search_by_projection_with_vis_plain`. The `per_frame` call (the
    tracked frame's) is timed with CUDA events, its bound counted from its
    shapes. Returns B6's (error, ms, plain ms, bytes, operations) and R's
    arguments on that call."""
    from orb_slam2_refactored_tpu_torch.ops import hamming, matching

    row, frame_r = None, None
    for name, a in cases.items():
        b6 = {k: a[k] for k in B6_ARGS if k in a}
        got = matching.project_candidates(**b6)
        ref = matching.project_candidates_plain(**b6)
        torch.cuda.synchronize()
        bad = [f for f in matching.Candidates._fields
               if not _same_bits(getattr(got, f), getattr(ref, f))]
        idx, best, _ = hamming.masked_best2_gated(
            got.desc, a["frame_desc"], got.ok, a["frame_valid"], got.uv,
            got.rad, got.lvl, a["frame_xy"], a["frame_level"])
        # B6's rows are the geometry's workspace, which the next search
        # writes: R's recorded arguments keep copies
        r_args = dict(target_idx=idx, dist=best, row_ok=got.ok.clone(),
                      max_dist=a.get("max_dist", hamming.TH_HIGH),
                      n_targets=a["frame_desc"].shape[0],
                      slot=got.slot.clone())
        r_same = all(torch.equal(x, y) for x, y in zip(
            hamming.resolve_to_points(**r_args),
            hamming.resolve_to_points_plain(**r_args)))
        out, vis = matching.search_by_projection_with_vis(**a)
        ref_out, ref_vis = matching.search_by_projection_with_vis_plain(**a)
        whole = all(torch.equal(x, y) for x, y in zip(
            (*out, vis), (*ref_out, ref_vis)))
        print(f"  B6 {name}: {a['mp_pos'].shape[0]} points, "
              f"{int(ref.vis.sum())} visible, {int(ref.ok.sum())} of "
              f"{ref.ok.shape[0]} rows passing, {int(out.valid.sum())} "
              f"matched; fields that differ {bad}; R (projection mode) "
              f"equal {r_same}; B6, K1, R equal to the plain search {whole}")
        assert not bad and r_same and whole, name
        if name == per_frame:
            nbytes, ops = b6_work(a)
            row = (0, cuda_time_ms(lambda: matching.project_candidates(**b6),
                                   50),
                   cuda_time_ms(lambda: matching.project_candidates_plain(
                       **b6), 10), nbytes, ops)
            frame_r = r_args
    return row, frame_r


def check_claims(cases, per_frame):
    """Phase 4: R against its plain version bit for bit on the
    `resolve_duplicates` and `resolve_rows` calls the main paths made (the
    tracked frame's: its motion-model search's rows call first, then its
    mapping job's where it made a keyframe; triangulation's and fusion's);
    the `per_frame` calls (`r_entry` tells the modes apart) timed with
    CUDA events, their bounds counted from their shapes. Returns R's
    (error, ms, plain ms, bytes, operations) over them."""
    for name, a in cases.items():
        got, ref = r_entry(a)(**a), r_entry(a, plain=True)(**a)
        torch.cuda.synchronize()
        keep = ref[-1] if isinstance(ref, tuple) else ref
        same = (all(torch.equal(x, y) for x, y in zip(got, ref))
                if isinstance(ref, tuple) else bool(torch.equal(got, ref)))
        print(f"  R {name} ({r_entry(a).__name__}): "
              f"{a['target_idx'].shape[0]} rows over {a['n_targets']} "
              f"targets, {int(a['valid'].sum())} valid, {int(keep.sum())} "
              f"kept; equal {same}")
        assert same, name
    ms = plain_ms = 0.0
    nbytes, ops = 0, {}
    for a in per_frame:
        fn, plain = r_entry(a), r_entry(a, plain=True)
        ms += cuda_time_ms(lambda: fn(**a), 50)
        plain_ms += cuda_time_ms(lambda: plain(**a), 10)
        b, o = r_work(a)
        nbytes += b
        add_ops(ops, **o)
    return 0, ms, plain_ms, nbytes, ops


def b6_r_device_times(sbp_call, r_calls, b6_r, claims_r, mm_call, feat_r):
    """Phase 5: the device time and operations of B6 (both modes) and of
    the tracked frame's R calls (`r_calls`), and of their plain versions;
    of the whole projection search (B6, K1, R) beside the plain
    composition (the path before the kernels: 119 operations with its K1
    launch); of the whole motion-model search (`mm_call`: B6's feature
    mode, K1, R) beside its plain composition; and each search's launches
    by `kernels.LAUNCHES` (three each). The three kernel rows' tuples gain
    their device ms, the wrappers' host us a call are printed."""
    from orb_slam2_refactored_tpu_torch import kernels
    from orb_slam2_refactored_tpu_torch.ops import matching

    a = sbp_call
    b6 = {k: a[k] for k in B6_ARGS if k in a}
    fa = features_args(mm_call)
    out = {}

    def r_fn(plain):
        calls = [(r_entry(c, plain), c) for c in r_calls]
        return lambda: [fn(**c) for fn, c in calls]

    for name, fn in (
            ("B6", lambda: matching.project_candidates(**b6)),
            ("B6 plain", lambda: matching.project_candidates_plain(**b6)),
            ("B6 features", lambda: matching.project_features(**fa)),
            ("B6 features plain",
             lambda: matching.project_features_plain(**fa)),
            ("R, the tracked frame's calls", r_fn(False)),
            ("R plain", r_fn(True)),
            ("search (B6, K1, R)",
             lambda: matching.search_by_projection_with_vis(**a)),
            ("search plain (K1 on the card)",
             lambda: matching.search_by_projection_with_vis_plain(**a)),
            ("motion-model search (B6 features, K1, R)",
             lambda: matching.search_last_frame_mapped(**mm_call)),
            ("motion-model search plain (K1 on the card)",
             lambda: matching.search_last_frame_mapped_plain(**mm_call))):
        n_ops = []
        ms, rows = profiled_ms(fn, 20, n_ops)
        out[name] = {"device_ms": ms, "device_ops": n_ops[0]}
        print(f"  {name}: device time {ms:.5f} ms, {n_ops[0]:g} device "
              f"operations: {rows[:6]}")
    for name, r in (("B6", b6_r), ("B6 features", feat_r),
                    ("R, the tracked frame's calls", claims_r)):
        b_ms, b_by = bound_ms(r[3], r[4])
        out[name].update(card_ms=r[1], plain_card_ms=r[2], bound_ms=b_ms,
                         bound_by=b_by)
    out["B6"]["host_us"] = host_us(lambda: matching.project_candidates(**b6))
    out["B6 features"]["host_us"] = host_us(
        lambda: matching.project_features(**fa))
    out["R, the tracked frame's calls"]["host_us"] = host_us(r_fn(False))
    for name, fn in (("search (B6, K1, R)",
                      lambda: matching.search_by_projection_with_vis(**a)),
                     ("motion-model search (B6 features, K1, R)",
                      lambda: matching.search_last_frame_mapped(
                          **mm_call))):
        before = kernels.counts()
        fn()
        after = kernels.counts()
        out[name]["launches"] = {k: after[k] - before[k] for k in after
                                 if after[k] != before[k]}
        assert sum(out[name]["launches"].values()) == 3, out[name]
    out["points"] = a["mp_pos"].shape[0]
    out["candidate_cap"] = a.get("candidate_cap", 8192)
    out["features"] = mm_call["last_mp"].shape[0]
    print("B6 and R on the tracked frame: " + json.dumps(out))
    return (b6_r + (out["B6"]["device_ms"],),
            claims_r + (out["R, the tracked frame's calls"]["device_ms"],),
            feat_r + (out["B6 features"]["device_ms"],))


# ---------------------------------------------------------------------------
# the facade, its settings file, the dataset readers and the CLI (cell I,
# phase 3j), and the learned pattern's kernel K7
# ---------------------------------------------------------------------------

# cell I: the bench's RGB-D camera (`bench.py:98-107`) in the reference's
# settings schema, with the learned BRIEF table; the CLI passes no map
# capacity, so the tracker takes `TrackerConfig`'s default
CELL_I_SETTINGS = """%YAML:1.0
# the bench's VGA RGB-D camera, the learned BRIEF table
Camera.fx: 520.0
Camera.fy: 520.0
Camera.cx: 320.0
Camera.cy: 240.0
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.k3: 0.0
Camera.width: 640
Camera.height: 480
Camera.fps: 30.0
Camera.bf: 41.6
Camera.RGB: 1
ThDepth: 35.0
DepthMapFactor: 5000.0
ORBextractor.nFeatures: 1000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
ORBextractor.pattern: learned
"""
# phase 3j: the JAX driver tests' QVGA cameras
# (tests/test_stereo_dataset_drivers.py, tests/test_mono_drivers.py)
QVGA_SETTINGS = """%YAML:1.0
Camera.fx: 260.0
Camera.fy: 260.0
Camera.cx: 160.0
Camera.cy: 120.0
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.k3: 0.0
Camera.width: 320
Camera.height: 240
Camera.fps: {fps}
Camera.bf: 20.8
Camera.RGB: 1
ThDepth: 35.0
ORBextractor.nFeatures: 600
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 4
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""
DRIVER_FRAMES = 40
STEREO_DRIVER_ATE_M = 0.05  # tests/test_stereo_dataset_drivers.py:141
MONO_DRIVER_ATE_M = 0.3     # tests/test_mono_drivers.py:103


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)
    return path


@contextlib.contextmanager
def _driver_report(out):
    """Inside the block, the CLI's report hands its step times and its
    system to `out` (the CLI keeps them to itself otherwise)."""
    from orb_slam2_refactored_tpu_torch import drivers

    real = drivers._report

    def report(times, system, *a):
        out["times"], out["system"] = list(times), system
        return real(times, system, *a)

    drivers._report = report
    try:
        yield out
    finally:
        drivers._report = real


def _read_tum_file(path):
    from orb_slam2_refactored_tpu_torch.geometry import se3

    v = np.loadtxt(path, ndmin=2)
    wc = torch.tensor(v[:, [7, 4, 5, 6, 1, 2, 3]], dtype=torch.float32)
    return v[:, 0], se3.inverse(wc).numpy()


def _read_kitti_file(path):
    """KITTI rows (3x4 row-major Twc) -> world->camera poses f32[N,7]."""
    from orb_slam2_refactored_tpu_torch.geometry import se3

    m = torch.tensor(np.loadtxt(path, ndmin=2).reshape(-1, 3, 4),
                     dtype=torch.float32)
    wc = se3.make(se3.quat_from_matrix(m[:, :, :3]), m[:, :, 3])
    return se3.inverse(wc).numpy()


def run_cell_i(imgs, depths, gt, tmp):
    """Cell I: cell A's 120 VGA frames written in the TUM layout through
    `io/png.py` (8-bit gray, depth x 5000 in 16 bits), then
    `drivers.main(["rgbd_tum", ...])` in this process on cuda:0 with the
    bench's camera and the learned pattern, every launch counter set to 0
    just before and read just after. Gates: rc 0; the TUM file's 120 lines
    on the sequence's timestamps; the saved file's ATE against
    groundtruth.txt (timestamps associated) <= 3 cm; no frame lost; the
    KITTI file's 120 lines of 12 numbers; the keyframe file's line a live
    keyframe; every kernel of the path launched, K7 once a frame, K3 never;
    window BA at every keyframe after the second."""
    import os

    from orb_slam2_refactored_tpu_torch import drivers, kernels
    from orb_slam2_refactored_tpu_torch.io.datasets import (
        load_tum_groundtruth)
    from orb_slam2_refactored_tpu_torch.io.evaluation import ate_rmse_assoc
    from orb_slam2_refactored_tpu_torch.io.synthetic import (
        write_tum_sequence)

    seq = os.path.join(tmp, "cell_i")
    t0 = time.perf_counter()
    write_tum_sequence(seq, ((imgs[i], depths[i].astype(np.float32))
                             for i in range(len(imgs))), gt, fps=30.0)
    t_write = time.perf_counter() - t0
    settings = _write(os.path.join(tmp, "cell_i.yaml"), CELL_I_SETTINGS)
    out, kf_out, kitti_out = (os.path.join(tmp, f"cell_i_{n}.txt")
                              for n in ("tum", "kf", "kitti"))
    rep = {}
    kernels.reset_counts()
    t0 = time.perf_counter()
    with _driver_report(rep):
        rc = drivers.main(["rgbd_tum", "--settings", settings, "--sequence",
                           seq, "--out", out, "--kf-out", kf_out,
                           "--kitti-out", kitti_out, "--no-loop-closing"])
    torch.cuda.synchronize()
    launches = kernels.counts()
    wall = time.perf_counter() - t0
    system = rep["system"]
    tracker = system.tracker
    n = len(imgs)
    est_ts, est_cw = _read_tum_file(out)
    gt_ts, gt_cw = load_tum_groundtruth(os.path.join(seq, "groundtruth.txt"))
    with open(os.path.join(seq, "rgb.txt")) as f:
        seq_ts = [ln.split()[0] for ln in f if ln.strip()
                  and not ln.startswith("#")]
    with open(out) as f:
        out_ts = [ln.split()[0] for ln in f]
    ate, _, n_assoc = ate_rmse_assoc(est_ts, est_cw, gt_ts, gt_cw)
    kitti_rows = np.loadtxt(kitti_out, ndmin=2)
    with open(kf_out) as f:
        kf_lines = len(f.read().splitlines())
    lost = sum(1 for t in tracker.track_info if t.get("lost"))
    created = 1 + sum(1 for t in tracker.track_info if t.get("kf"))
    n_ba = tracker.local_mapper.n_ba
    steps = np.asarray(rep["times"][WARMUP_FRAMES:])
    cap = tracker.cfg.map_capacity
    stats = {
        "cell": "I", "frames": n, "rc": rc, "ate_saved_file_m": ate,
        "associated": n_assoc, "lost_frames": lost,
        "keyframes_created": created,
        "keyframes_alive": len(tracker.graph.alive_kfs()),
        "window_ba_solves": n_ba, "pattern": tracker.cfg.descriptor_pattern,
        "map_capacity": [cap.max_keyframes, cap.max_points,
                         cap.max_features],
        "step_ms_median": float(np.median(steps) * 1e3),
        "step_ms_p90": float(np.percentile(steps, 90) * 1e3),
        "write_s": t_write, "wall_s": wall, "launches": launches}
    print("cell I (rgbd_tum CLI, learned pattern) " + json.dumps(stats))
    assert rc == 0
    assert out_ts == seq_ts and len(out_ts) == n, (len(out_ts), n)
    assert ate <= ATE_GATE_M, f"cell I: ATE of the saved file {ate} m"
    assert lost == 0, f"cell I: {lost} frames lost"
    assert kitti_rows.shape == (n, 12), kitti_rows.shape
    assert kf_lines == len(tracker.graph.alive_kfs()), kf_lines
    for k, v in launches.items():
        if k == LARGE_KERNEL or off_cell(k, v, "cell I"):
            continue  # `extraction_launches` holds K9's large kernel
        if k in ("stereo_sad", "orb_desc") or k in LOOP_KERNELS:
            assert v == 0, f"{k} launched on cell I"
        else:
            assert v > 0, f"kernel {k} never launched on cell I"
    assert launches[LEARNED_KERNEL] == launches["fast"] == n, launches
    extraction_launches(launches, n, "cell I")
    assert n_ba >= created - 2 >= 1, (n_ba, created)
    return stats, system, seq


def k8_layout(levels):
    """Copies of pyramid `levels` laid out as kernel K8 writes them, so
    that K7 takes its launch table as on the main path: level 0 alone,
    levels 1.. views of one buffer at `image_ops.buffer_offsets`."""
    from orb_slam2_refactored_tpu_torch.ops import image as image_ops

    offsets, total = image_ops.buffer_offsets([tuple(l.shape)
                                               for l in levels[1:]])
    buf = torch.empty((total,), dtype=torch.float32,
                      device=levels[0].device)
    out = [levels[0].clone()]
    for lvl, o in zip(levels[1:], offsets):
        v = buf.as_strided(tuple(lvl.shape), (lvl.shape[1], 1), o)
        v.copy_(lvl)
        out.append(v)
    return out


def record_tracked_frame_i(system, seq):
    """The K7 call of one more frame that cell I's system tracks (the
    sequence's frame 0 again, read by the port's reader: the orbit
    closes)."""
    from orb_slam2_refactored_tpu_torch.io import datasets
    from orb_slam2_refactored_tpu_torch.ops import orb

    ts, img, depth = next(datasets.tum_rgbd_sequence(seq))
    k7 = []
    with recording(k7, (orb, "angles_and_descriptors_learned_levels")):
        system.track_rgbd(img, depth, ts + 120 / 30.0)
    info = system.tracker.track_info[-1]
    assert not info.get("lost"), info
    assert len(k7) == 1, len(k7)
    return k7[0]


def run_driver_cells(tmp):
    """Phase 3j: the `stereo_kitti`, `mono_tum` and `stereo_euroc` CLIs on
    the card, on the JAX driver tests' own exports and gates: a 40-frame
    QVGA KITTI stereo export (`tests/test_stereo_dataset_drivers.py:115-141`:
    one KITTI line a frame, ATE < 5 cm against poses_gt.txt), a 40-frame
    TUM export through `mono_tum` (`tests/test_mono_drivers.py:68-103`: >=
    30 tracked lines, sim3 ATE < 0.3 m over >= 25 associated frames), and
    40 raw EuRoC pairs through `stereo_euroc` at QVGA and at 752x480
    (`run_euroc_cli`)."""
    import os

    from orb_slam2_refactored_tpu_torch import drivers, kernels
    from orb_slam2_refactored_tpu_torch.io.datasets import (
        load_tum_groundtruth)
    from orb_slam2_refactored_tpu_torch.io.evaluation import (
        ate_rmse, ate_rmse_assoc)
    from orb_slam2_refactored_tpu_torch.io.synthetic import (
        SyntheticScene, box_room, export_kitti_sequence, export_tum_sequence,
        orbit_trajectory)

    planes = box_room(half_x=1.5, half_y=1.2, z_far=2.5, z_near=-2.5)
    res = {}
    # stereo_kitti
    t0 = time.perf_counter()
    kitti = os.path.join(tmp, "kitti")
    export_kitti_sequence(kitti, SyntheticScene(
        width=320, height=240, fx=260.0, fy=260.0, baseline=0.08,
        planes=planes), orbit_trajectory(DRIVER_FRAMES, radius=0.3,
                                         yaw_amp=0.2), fps=10.0)
    t_export = time.perf_counter() - t0
    settings = _write(os.path.join(tmp, "kitti.yaml"),
                      QVGA_SETTINGS.format(fps=10.0))
    k_out = os.path.join(tmp, "kitti_traj.txt")
    kernels.reset_counts()
    t0 = time.perf_counter()
    rc = drivers.main(["stereo_kitti", "--settings", settings, "--sequence",
                       kitti, "--out", os.path.join(tmp, "kitti_tum.txt"),
                       "--kitti-out", k_out, "--no-loop-closing"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.counts()
    est = _read_kitti_file(k_out)
    ate, _ = ate_rmse(est, _read_kitti_file(os.path.join(kitti,
                                                         "poses_gt.txt")),
                      align="se3")
    res["stereo_kitti"] = {"rc": rc, "lines": len(est), "ate_m": ate,
                           "export_s": t_export, "wall_s": wall,
                           "launches": launches}
    print("phase 3j stereo_kitti CLI " + json.dumps(res["stereo_kitti"]))
    assert rc == 0 and len(est) == DRIVER_FRAMES, len(est)
    assert ate < STEREO_DRIVER_ATE_M, f"stereo_kitti: ATE {ate} m"
    assert launches["fast"] == launches["orb_desc"] == 2 * DRIVER_FRAMES
    assert launches["stereo_sad"] == DRIVER_FRAMES, launches
    extraction_launches(launches, 2 * DRIVER_FRAMES, "3j stereo_kitti")
    # mono_tum
    t0 = time.perf_counter()
    tum = os.path.join(tmp, "mono_tum")
    export_tum_sequence(tum, SyntheticScene(
        width=320, height=240, fx=260.0, fy=260.0, planes=planes),
        orbit_trajectory(DRIVER_FRAMES, radius=0.35, yaw_amp=0.3), fps=30.0)
    t_export = time.perf_counter() - t0
    settings = _write(os.path.join(tmp, "mono.yaml"),
                      QVGA_SETTINGS.format(fps=30.0))
    m_out = os.path.join(tmp, "mono_traj.txt")
    kernels.reset_counts()
    t0 = time.perf_counter()
    rc = drivers.main(["mono_tum", "--settings", settings, "--sequence", tum,
                       "--out", m_out, "--no-loop-closing"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.counts()
    est_ts, est_cw = _read_tum_file(m_out)
    gt_ts, gt_cw = load_tum_groundtruth(os.path.join(tum, "groundtruth.txt"))
    ate, _, n_assoc = ate_rmse_assoc(est_ts, est_cw, gt_ts, gt_cw,
                                     align="sim3")
    res["mono_tum"] = {"rc": rc, "lines": len(est_ts), "ate_sim3_m": ate,
                       "associated": n_assoc, "export_s": t_export,
                       "wall_s": wall, "launches": launches}
    print("phase 3j mono_tum CLI " + json.dumps(res["mono_tum"]))
    assert rc == 0 and len(est_ts) >= 30, len(est_ts)
    assert n_assoc >= 25 and ate < MONO_DRIVER_ATE_M, (n_assoc, ate)
    assert launches["fast"] == launches["orb_desc"] == DRIVER_FRAMES
    extraction_launches(launches, DRIVER_FRAMES, "3j mono_tum")
    # stereo_euroc on raw pairs, rectified from the LEFT./RIGHT. blocks
    for tag, rig_args, orb_args in EUROC_RIGS:
        res[f"stereo_euroc_{tag}"] = run_euroc_cli(tmp, tag, rig_args,
                                                   orb_args, planes)
    return res


# phase 3j's stereo_euroc runs: the JAX driver test's QVGA rig and export
# (tests/test_stereo_dataset_drivers.py:60-73, :202-245: 600 features, 4
# levels), and EuRoC's full width with EuRoC.yaml's extractor settings
# (1200 features, 8 levels, 1.2, ThDepth 35)
EUROC_RIGS = (
    ("qvga", dict(width=320, height=240, fx_rect=260.0, baseline=0.08),
     dict(n_features=600, n_levels=4)),
    ("752x480", dict(width=752, height=480, fx_rect=435.2, baseline=0.11),
     dict(n_features=1200, n_levels=8, th_depth=35.0)),
)


def run_euroc_cli(tmp, tag, rig_args, orb_args, planes):
    """`drivers.main(["stereo_euroc", ...])` on cuda:0, loop closing off,
    on a 40-frame EuRoC-layout export of raw (distorted, rotated) pairs
    whose settings carry LEFT./RIGHT. blocks, so the driver rectifies every
    pair (`io/datasets.py::EurocRectifier`, on the host, timed a pair).
    Gates (the JAX driver test's): rc 0, ATE of the saved TUM file against
    groundtruth_tum.txt with timestamp association < 5 cm over at least
    N - 5 frames; two K2 and K3 calls and one B9 launch a pair."""
    import os

    from orb_slam2_refactored_tpu_torch import drivers, kernels
    from orb_slam2_refactored_tpu_torch.io import datasets
    from orb_slam2_refactored_tpu_torch.io.evaluation import ate_rmse_assoc
    from orb_slam2_refactored_tpu_torch.io.synthetic import (
        euroc_settings_yaml, export_euroc_sequence, make_euroc_rig,
        orbit_trajectory)

    t0 = time.perf_counter()
    rig = make_euroc_rig(**rig_args)
    seq = export_euroc_sequence(
        os.path.join(tmp, f"euroc_{tag}"), planes,
        orbit_trajectory(DRIVER_FRAMES, radius=0.3, yaw_amp=0.2), rig=rig,
        fps=20.0)
    t_export = time.perf_counter() - t0
    settings = _write(os.path.join(tmp, f"euroc_{tag}.yaml"),
                      euroc_settings_yaml(rig, **orb_args))
    out = os.path.join(tmp, f"euroc_{tag}_traj.txt")
    pair_s, call = [], datasets.EurocRectifier.__call__

    def timed(self, img_l, img_r):
        t = time.perf_counter()
        pair = call(self, img_l, img_r)
        pair_s.append(time.perf_counter() - t)
        return pair

    datasets.EurocRectifier.__call__ = timed
    kernels.reset_counts()
    t0 = time.perf_counter()
    try:
        rc = drivers.main(["stereo_euroc", "--settings", settings,
                           "--sequence", seq, "--timestamps",
                           os.path.join(seq, "timestamps.txt"), "--out", out,
                           "--no-loop-closing"])
        torch.cuda.synchronize()
    finally:
        datasets.EurocRectifier.__call__ = call
    wall = time.perf_counter() - t0
    launches = kernels.counts()
    est_ts, est_cw = _read_tum_file(out)
    gt_ts, gt_cw = datasets.load_tum_groundtruth(
        os.path.join(seq, "groundtruth_tum.txt"))
    ate, _, n_assoc = ate_rmse_assoc(est_ts, est_cw, gt_ts, gt_cw,
                                     max_dt=0.01)
    ms = np.asarray(pair_s) * 1e3
    r = {"rc": rc, "size": [rig["width"], rig["height"]], **orb_args,
         "lines": len(est_ts), "associated": n_assoc, "ate_m": ate,
         "rectifier_host_ms_a_pair": {
             "pairs": len(ms), "median": float(np.median(ms)),
             "min": float(ms.min()), "max": float(ms.max())},
         "export_s": t_export, "wall_s": wall, "launches": launches}
    print(f"phase 3j stereo_euroc CLI ({tag}, rectified) " + json.dumps(r))
    assert rc == 0 and len(ms) == DRIVER_FRAMES, (rc, len(ms))
    assert n_assoc >= DRIVER_FRAMES - 5, n_assoc
    assert ate < STEREO_DRIVER_ATE_M, f"stereo_euroc {tag}: ATE {ate} m"
    assert launches["fast"] == launches["orb_desc"] == 2 * DRIVER_FRAMES
    assert launches["stereo_sad"] == DRIVER_FRAMES, launches
    extraction_launches(launches, 2 * DRIVER_FRAMES, f"3j stereo_euroc {tag}")
    return r


# ---------------------------------------------------------------------------
# phase 3k: cameras past VGA (K9's large kernel, K8's search past 4 x 132
# blocks)
# ---------------------------------------------------------------------------

# tracked runs: frames a geometry and whether the bench's ATE gate holds
GEOMETRY_RUNS = {(1200, 1920): (30, True), (2160, 3840): (10, False)}
# K8, K2, K9 and K3 held against their plain versions on two frames
GEOMETRY_CHECKS = ((1200, 1920), (1088, 2048), (2160, 3840))


def geometry_config(h, w):
    """The bench's RGB-D configuration (`bench_config(True)`: 1000
    features, 8 levels, 1.2, local BA on) at an [h, w] camera with the
    bench's field of view: fx = fy = 520 w / 640, the principal point at
    the centre, bf = 0.08 fx."""
    import dataclasses

    fx = 520.0 * w / 640
    return dataclasses.replace(bench_config(True), width=w, height=h, fx=fx,
                               fy=fx, cx=w / 2.0, cy=h / 2.0, bf=0.08 * fx)


def geometry_frames(h, w, n):
    """The bench's box-room orbit (`bench_frames`: its room, its 120-view
    trajectory, 1 % depth noise from numpy seed 0), its first n views
    rendered at [h, w] with `geometry_config`'s camera; numpy, frames
    rendered on host threads."""
    from concurrent.futures import ThreadPoolExecutor

    from orb_slam2_refactored_tpu_torch.io.synthetic import (
        SyntheticScene, box_room, orbit_trajectory)

    fx = 520.0 * w / 640
    scene = SyntheticScene(width=w, height=h, fx=fx, fy=fx, planes=box_room(
        half_x=1.8, half_y=1.4, z_far=3.0, z_near=-3.0))
    gt = orbit_trajectory(N_FRAMES, radius=0.4, yaw_amp=0.3)[:n]
    with ThreadPoolExecutor(8) as pool:
        views = list(pool.map(scene.render, gt))
    rng = np.random.default_rng(0)
    imgs = np.stack([np.clip(img, 0, 255).astype(np.uint8)
                     for img, _ in views])
    depths = np.stack([(d * (1 + rng.normal(0, 0.01, d.shape))).astype(
        np.float16) for _, d in views])
    return imgs, depths, gt


def geometry_misses(h, w, device_str):
    """Outputs of the geometry's 14 products that no split of the card's
    GEMM explains (`SPLIT_MISSES`, found when K8's tables were built)."""
    from orb_slam2_refactored_tpu_torch.ops import image as image_ops

    shapes = image_ops.pyramid_shapes(h, w, 8, 1.2)
    return sum(image_ops.SPLIT_MISSES.get((a, b, o, v, device_str), 0)
               for (ih, iw), (oh, ow) in zip(shapes[:-1], shapes[1:])
               for a, b, o, v in ((ih, oh, iw, True), (iw, ow, oh, False))
               if a != b)


def run_geometry(h, w, device):
    """One camera geometry's tracked run: `geometry_frames` through
    `Tracker.track_rgbd` on cuda:0, every launch counter set to 0 just
    before and read just after. Prints the tracker's construction time
    (K8's GEMM probes and work split, K9's and K3's tables). Gates: no
    frame lost; at 1920x1200 the bench's ATE gate (3 cm); K8, K2, K9 and
    K9's large kernel once a frame, K3 once a frame, K1 and K4 launched.
    Returns the run's stats and its first two frames."""
    from orb_slam2_refactored_tpu_torch import kernels
    from orb_slam2_refactored_tpu_torch.io.evaluation import ate_rmse
    from orb_slam2_refactored_tpu_torch.slam.tracking import Tracker
    from orb_slam2_refactored_tpu_torch.utils.timing import StageTimer

    n, gated = GEOMETRY_RUNS[(h, w)]
    t0 = time.perf_counter()
    imgs, depths, gt = geometry_frames(h, w, n)
    t_render = time.perf_counter() - t0
    t0 = time.perf_counter()
    tracker = Tracker(geometry_config(h, w), device=device)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    timer = StageTimer(device)
    kernels.reset_counts()
    for i in range(n):
        with timer.time("step"):
            tracker.track_rgbd(imgs[i], depths[i].astype(np.float32),
                               timestamp=i / 30.0)
    launches = kernels.counts()
    tracker.flush()
    est = np.stack(tracker.trajectory)
    assert est.shape == gt.shape and np.isfinite(est).all()
    ate, _ = ate_rmse(est, gt, align="se3")
    lost = sum(1 for t in tracker.track_info if t.get("lost"))
    step = np.asarray(timer.samples["step"][1:]) * 1e3
    stats = {"size": [w, h], "frames": n, "ate_m": ate, "lost_frames": lost,
             "tracker_construction_s": t_build,
             "split_misses": geometry_misses(h, w, str(device)),
             "keyframes_created": 1 + sum(1 for t in tracker.track_info
                                          if t.get("kf")),
             "step_ms_median": float(np.median(step)),
             "step_ms_max": float(step.max()), "render_s": t_render,
             "launches": launches}
    print(f"phase 3k {w}x{h} " + json.dumps(stats))
    assert lost == 0, f"{w}x{h}: {lost} frames lost"
    if gated:
        assert ate <= ATE_GATE_M, f"{w}x{h}: ATE {ate} m above the gate"
    assert launches["fast"] == launches["orb_desc"] == n, launches
    assert launches["hamming_best2"] > 0 and launches["pose_lm"] > 0
    extraction_launches(launches, n, f"3k {w}x{h}", large=True)
    return stats, imgs[:2]


def check_geometry(h, w, imgs, device):
    """K8, K2, K9 and K3 against their plain versions at an [h, w] camera
    on two frames, as extraction calls them: K8 bit for bit where no output
    of the geometry's products misses its GEMM split (`SPLIT_MISSES` 0),
    else within 1e-4 gray; K2 and K9 bit for bit; K3 as phase 2 holds it.
    Then K8's and K9's time on the second frame: CUDA events around 50
    calls back to back, which at these sizes keep the card busy (no
    torch.profiler window here: on the H100 windows taken late in the run
    lost launches, PERF.md §7). Returns the geometry's numbers, and K9's
    large kernel's alone where it launches (its levels through the
    wrapper, which launches only the large kernel for them)."""
    from orb_slam2_refactored_tpu_torch.ops import fast
    from orb_slam2_refactored_tpu_torch.ops import image as image_ops
    from orb_slam2_refactored_tpu_torch.ops import orb

    t0 = time.perf_counter()
    ext = orb.OrbExtractor(h, w, 1000, 1.2, 8, device=device)
    torch.cuda.synchronize()
    t_plan = time.perf_counter() - t0
    tag = f"{w}x{h}"
    misses = geometry_misses(h, w, str(device))
    for i, img in enumerate(imgs):
        gray = image_ops.to_gray(torch.as_tensor(img, device=device))
        levels = image_ops.build_pyramid(gray, 8, 1.2)
        ref = image_ops.build_pyramid_plain(gray, 8, 1.2)
        torch.cuda.synchronize()
        err, share = pyramid_agreement(levels, ref)
        print(f"  K8 {tag} frame {i}: SPLIT_MISSES {misses}, max_abs_err "
              f"per level {err}, bit-equal share per level {share}")
        if misses == 0:
            assert all(x == 1.0 for x in share), (tag, share)
        else:
            assert max(err) <= 1e-4, (tag, err)
        check_fast(levels, ext.budgets, f"{tag} frame {i}")
        check_topk(levels, ext.budgets, ext.level_scales, f"{tag} frame {i}")
        check_orb(levels, *level_keypoints(levels, ext.budgets), ext.budgets,
                  f"{tag} frame {i}")
    shapes = [tuple(x.shape) for x in levels]
    k2 = fast.detect_and_rank(levels, 20.0, 7.0, ext.budgets,
                              margin=orb.EDGE_MARGIN)
    ranked = [(r, p) for _, r, p in k2]
    args = (ranked, ext.budgets, shapes, list(range(8)), ext.level_scales)
    plan = image_ops.prepare_pyramid(h, w, 8, 1.2, device)
    res = {"size": [w, h], "extractor_construction_s": t_plan,
           "split_misses": misses,
           "k8_grid": [len(plan.rows), len(plan.cols)],
           "k9_candidates": [r.numel() for r, _ in ranked],
           "k9_launches": list(orb.prepare_spread_topk(
               h, w, 1000, 1.2, 8).launches)}
    for name, fn in (
            ("K8", lambda: image_ops.build_pyramid(gray, 8, 1.2)),
            ("K9", lambda: orb.spread_topk_levels(*args,
                                                  buffers=k2.buffers))):
        res[f"{name}_card_ms"] = cuda_time_ms(fn, 50)
    nbytes, ops = pyramid_work(shapes)
    res["K8_bound_ms"] = bound_ms(nbytes, ops)[0]
    res["K9_bound_ms"] = bound_ms(*topk_work(ranked, ext.budgets))[0]
    print(f"phase 3k {tag} K8 and K9 ({card_line()}): " + json.dumps(res))
    big = [l for l, (r, _) in enumerate(ranked)
           if r.numel() > orb.SPREAD_MAX_KEYS]
    if not big:
        return res, None
    large = ([ranked[l] for l in big], [ext.budgets[l] for l in big],
             [shapes[l] for l in big], big,
             [ext.level_scales[l] for l in big])
    assert orb.prepare_spread_topk(h, w, 1000, 1.2, 8).launches[-1] == \
        LARGE_KERNEL

    def call():
        return orb.spread_topk_levels(*large)

    def plain():
        return orb.spread_topk_levels_plain(*large)

    out, ref = call(), plain()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, ref)), tag
    library, _ = sort_topk(*large[:2])
    nbytes, ops = topk_work(*large[:2])
    r = (0.0, cuda_time_ms(call, 50), cuda_time_ms(plain, 20), nbytes, ops)
    lib_ms = cuda_time_ms(library, 50)
    print(f"  K9's large kernel {tag}, levels {big}: card {r[1]:.5f} ms, "
          f"plain {r[2]:.5f} ms, bound {bound_ms(nbytes, ops)[0]:.6f} ms, "
          f"library (stable sort) {lib_ms:.5f} ms")
    return res, (r, lib_ms)


def _desc_bits(d):
    return np.unpackbits(d.cpu().numpy().view(np.uint8), axis=1,
                         bitorder="little").astype(bool)


def check_orb_learned(levels, ys, xs, ks, tag, timed=False):
    """K7 against its plain version on one frame's keypoints (the one
    launch over every level, as extraction makes it): fed the plain
    version's angles, its descriptors bit for bit and the angles returned
    as given; whole (its own angles), level-0 angles equal, the others
    within 3e-5 rad, and every descriptor bit equal except at the tests of
    `learned_tie_gate` (a rotated coordinate within 1e-4 of a half-integer,
    widened by 18 px times the keypoint's angle difference, or the blurred
    samples within 1e-3 gray): those exceptions are counted, printed and
    must be under 0.1 % of the tests. A control must fail the same hold:
    the table with pair 5 swapped. With `timed`, CUDA events time the
    launch and the plain version, and the bound is counted."""
    from orb_slam2_refactored_tpu_torch.ops import orb

    def call():
        return orb.angles_and_descriptors_learned_levels(levels, ys, xs, ks)

    def plain():
        return orb.angles_and_descriptors_learned_plain(levels, ys, xs, ks)

    ap, dp = plain()
    ag, dg = orb.angles_and_descriptors_learned_levels(levels, ys, xs, ks,
                                                       angles=ap)
    ak, dk = call()
    pat = orb.learned_pattern().copy()
    pat[5] = pat[5, ::-1]
    _, dx = orb.angles_and_descriptors_learned_levels(levels, ys, xs, ks,
                                                      pattern=pat)
    torch.cuda.synchronize()
    given = bool(torch.equal(ag, ap) and torch.equal(dg, dp))
    d = (torch.remainder(ak - ap + math.pi, 2 * math.pi) - math.pi).abs()
    lvl0_equal = bool(torch.equal(ak[:ks[0]], ap[:ks[0]]))
    gate = orb.learned_tie_gate(levels, ys, xs, ks, ap,
                                half_tol=1e-4 + 18 * d.double()
                                ).cpu().numpy()
    bp = _desc_bits(dp)
    diff = _desc_bits(dk) != bp
    outside = int((diff & ~gate).sum())
    excepted = int((diff & gate).sum())
    control = int(((_desc_bits(dx) != bp) & ~gate).sum())
    where = np.argwhere(diff & gate)[:8].tolist()
    print(f"  K7 {tag}: {ys.shape[0]} keypoints on {len(levels)} levels; "
          f"given the plain angles bit for bit {given}; own angles: level 0 "
          f"equal {lvl0_equal}, max_abs_err {float(d.max()):.3g} rad; bits "
          f"differing outside the gate {outside}, inside it (exceptions) "
          f"{excepted} of {diff.size} tests (gated {int(gate.sum())}), first "
          f"[keypoint, test] {where}; control (pair 5 swapped) differing "
          f"outside the gate {control}")
    assert given, "K7 given the angles differs from its plain version"
    assert lvl0_equal and float(d.max()) < 3e-5, float(d.max())
    assert outside == 0, f"K7: {outside} bits differ outside the gate"
    assert excepted <= 1e-3 * diff.size, excepted
    assert control > 100, f"the swapped-pair control was not told: {control}"
    if not timed:
        return float(d.max())
    # bytes: the level's pixels under the union of the 43x43 raw windows
    # (f32), the coordinates in, the angle and 8 descriptor words out
    r = orb.LEARNED_REACH + 3
    win = torch.arange(-r, r + 1, device=ys.device)
    moment_px = int(orb.circular_patch_masks()[0].sum())
    nbytes, ops, start = 0, {}, 0
    for lvl, K in zip(levels, ks):
        h, w = lvl.shape
        sl = slice(start, start + K)
        start += K
        yy = torch.clamp(ys[sl, None, None] + win[None, :, None], 0, h - 1)
        xx = torch.clamp(xs[sl, None, None] + win[None, None, :], 0, w - 1)
        covered = torch.zeros((h, w), dtype=torch.bool, device=lvl.device)
        covered[yy.long(), xx.long()] = True
        nbytes += int(covered.sum()) * 4 + K * 8 + K * 36
        # f32 instructions a keypoint, an FMA counted once: the separable
        # 7-tap blur (43x37 then 37x37 outputs), two moment FMAs a pixel of
        # the circular patch, and a test's four rotated coordinates (two
        # instructions each), two roundings and a compare
        add_ops(ops, f32=K * ((43 * 37 + 37 * 37) * 7 + 2 * moment_px
                              + 256 * 11))
    return (float(d.max()), cuda_time_ms(call, 50), cuda_time_ms(plain, 5),
            nbytes, ops)


# ---------------------------------------------------------------------------
# phase 3n: the sharded global BA (K6 split at its reductions)
# ---------------------------------------------------------------------------

SHARDED_RANKS = 2  # phase 3n's gloo ranks, both on cuda:0
SHARDED_TIMEOUT_S = 600


def off_cell(k, v, tag):
    """True for the kernels no cell of phases 3-3o launches, which must not
    have launched there: the sharded solve's (phase 3n drives them) and
    K10 (the cells send raw images and f16 depth; phase 3p the bench's
    log8 depth and the DCT image)."""
    if k in SHARDED_KERNELS + (WIRE_KERNEL,):
        assert v == 0, f"{k} launched on {tag}"
        return True
    return False


def free_port():
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def collectives_read():
    """The collectives since the last `kernels.reset_counts()`: {name:
    calls} and their host seconds."""
    from orb_slam2_refactored_tpu_torch import kernels

    return kernels.collective_counts(), kernels.collective_host_s()


def sharded_problems(rec, device):
    """Phase 3n's two solves as `ba_solve` arguments: `dryrun`'s problem
    (K=256 keyframes x 512 observations over 16,384 points, 2 LM x 8 CG)
    and cell F's first global BA as `check_gba` holds it."""
    from orb_slam2_refactored_tpu_torch.parallel import distributed

    prob, cam = distributed.make_ba_problem(device=device)
    return {"dryrun": {"p": prob, "cam": cam, "iters": 2, "cg_iters": 8},
            "F": dict(rec["ba_solve"][0])}


def solve_sharded(sa, group):
    from orb_slam2_refactored_tpu_torch.parallel.sharded_ba import (
        sharded_ba_solve)

    return sharded_ba_solve(sa["p"], sa["cam"], group=group,
                            iters=sa["iters"], cg_iters=sa["cg_iters"],
                            lambda0=sa.get("lambda0", 1e-4))


def sharded_rank_main(rank, world, coord, jobs_path):
    """One rank of phase 3n (b), a process of its own: gloo on cuda:0,
    the saved solves through `sharded_ba_solve`, the results saved beside
    the jobs."""
    import torch.distributed as dist

    from orb_slam2_refactored_tpu_torch import kernels
    from orb_slam2_refactored_tpu_torch.parallel import distributed

    dev = distributed.initialize(coord, world, rank, backend="gloo",
                                 device="cuda:0")
    out = {}
    jobs = torch.load(jobs_path, map_location=dev, weights_only=False)
    kernels.reset_counts()
    for name, sa in jobs.items():
        t0 = time.perf_counter()
        res = solve_sharded(sa, dist.group.WORLD)
        torch.cuda.synchronize()
        out[name] = {"kf_pose": res.kf_pose.cpu(),
                     "pt_pos": res.pt_pos.cpu(),
                     "c0": res.initial_cost.cpu(),
                     "c1": res.final_cost.cpu(),
                     "wall_s": time.perf_counter() - t0}
    out["launches"] = {n: kernels.counts()[n] for n in SHARDED_KERNELS}
    out["calls"], out["host_s"] = collectives_read()
    torch.save(out, f"{jobs_path}.rank{rank}")
    dist.destroy_process_group()


def sharded_device_times(k6_call, firsts, tmp):
    """Phase 3n's device times, from torch.profiler windows in a process of
    its own (`--sharded-times`): late in this process's run a window of
    20 `ba_cg_ut` launches recorded 12, in five tries, on the H100. Each
    entry on its recorded call (20 calls a window), the split CG with a
    world-size-1 NCCL group of the child's and K6's one launch on cell F's
    first LM iteration (5 calls a window). Returns {name: (ms, rows)}."""
    jobs = os.path.join(tmp, "sharded_times.pt")
    torch.save({"k6": k6_call, "entries": firsts}, jobs)
    p = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--sharded-times", "--jobs", jobs],
                       capture_output=True, text=True,
                       timeout=SHARDED_TIMEOUT_S)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    return torch.load(jobs + ".times", weights_only=False)


def sharded_times_main(jobs_path):
    """The child of `sharded_device_times`."""
    import torch.distributed as dist

    from orb_slam2_refactored_tpu_torch.optim import ba
    from orb_slam2_refactored_tpu_torch.parallel import distributed

    distributed.initialize(f"localhost:{free_port()}", 1, 0)
    jobs = torch.load(jobs_path, map_location="cuda:0", weights_only=False)
    k6 = jobs["k6"]
    comm = ba.ShardComm(dist.group.WORLD, k6["G"].shape[0])
    out = {n: profiled_ms(partial(getattr(ba, n), **_clone_args(a)), 20)
           for n, a in jobs["entries"].items()}
    out["split"] = profiled_ms(partial(ba.sharded_cg_solve, **k6,
                                       comm=comm), 5)
    out["k6"] = profiled_ms(partial(ba.ba_schur_cg, **k6), 5)
    dist.destroy_process_group()
    torch.save(out, jobs_path + ".times")


def rank_command(rank, coord, jobs):
    """The command of one rank of phase 3n (b): this script in its
    `--sharded-rank` mode."""
    return [sys.executable, os.path.abspath(__file__), "--sharded-rank",
            str(rank), "--world", str(SHARDED_RANKS), "--coord", coord,
            "--jobs", jobs]


def run_two_ranks(probs, tmp):
    """Phase 3n (b): `SHARDED_RANKS` processes on cuda:0 over gloo (NCCL
    refuses two ranks on one card), each solving `probs`; their saved
    results in rank order."""
    jobs = os.path.join(tmp, "sharded_jobs.pt")
    torch.save(probs, jobs)
    coord = f"localhost:{free_port()}"
    procs = [subprocess.Popen(rank_command(r, coord, jobs),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(SHARDED_RANKS)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SHARDED_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    return [torch.load(f"{jobs}.rank{r}", weights_only=False)
            for r in range(SHARDED_RANKS)]


def _clone_args(args):
    return {k: _clone(v) for k, v in args.items()}


def entry_readings(calls):
    """Phase 3n (c): each recorded call of the split CG's entries run
    again through the kernel and through its plain version (W_obs in the
    slot layout), both on copies of the recorded arguments; every output
    against the plain version in f64: at most CG_FACTOR x the f32 plain
    version's distance plus CG_FLOOR x the f64 result's largest magnitude,
    and the new direction p bit-equal to the plain version's. Returns
    {entry: (largest difference from the f32 plain version, the kernel's
    and the plain version's CUDA-event ms on the first iteration's call,
    bytes, ops)} and {entry: that call's arguments}."""
    from orb_slam2_refactored_tpu_torch.optim import ba

    firsts = {}
    outputs = {"ba_cg_ut": ("out", "p_out"), "ba_cg_ap": ("out", "pap"),
               "ba_cg_update": ("x", "r", "z", "rz")}
    plain = {"ba_cg_ut": ba.ba_cg_ut_plain, "ba_cg_ap": ba.ba_cg_ap_plain,
             "ba_cg_update": ba.ba_cg_update_plain}
    res = {}
    for name, recorded in calls.items():
        fn, worst, err = getattr(ba, name), 0.0, 0.0
        for c in recorded:
            slot = {k: (ba.w_obs_slot_rows(v) if isinstance(v, ba.LiveRows)
                        else v) for k, v in c.items()}
            # the entries write in place: each side gets its own copies
            k_args, p_args = _clone_args(c), _clone_args(slot)
            e_args = {k: _f64(v) for k, v in _clone_args(slot).items()}
            fn(**k_args)
            with deterministic():
                plain[name](**p_args)
                plain[name](**e_args)
            for o in outputs[name]:
                if o not in k_args:
                    continue
                k, r, e = k_args[o], p_args[o], e_args[o]
                err = max(err, float((k - r).abs().max()))
                if o == "p_out":
                    assert torch.equal(k, r), (name, o)
                    continue
                e_p = float((r.double() - e).abs().max())
                bound = CG_FACTOR * e_p + CG_FLOOR * float(e.abs().max())
                e_k = float((k.double() - e).abs().max())
                worst = max(worst, e_k / bound if bound else float(e_k > 0))
        first = next(c for c in recorded if c.get("it", 0) == 0
                     and ("p_out" in c or "p" in c))
        slot = {k: (ba.w_obs_slot_rows(v) if isinstance(v, ba.LiveRows)
                    else v) for k, v in first.items()}
        k_args, p_args = _clone_args(first), _clone_args(slot)
        ms = cuda_time_ms(lambda: fn(**k_args), 20)
        plain_ms = cuda_time_ms(lambda: plain[name](**p_args), 5)
        nbytes, ops = entry_work(name, first)
        res[name] = (err, ms, plain_ms, nbytes, ops)
        firsts[name] = first
        print(f"  {name}: {len(recorded)} recorded calls, largest share of "
              f"the f64 yardstick's bound {worst:.3g}, largest difference "
              f"from the f32 plain version {err:.3g}; card {ms:.5f} ms, "
              f"plain {plain_ms:.5f} ms a call")
        assert worst <= 1.0, (name, worst)
    return res, firsts


def entry_work(name, c):
    """Bytes (each input read once, each output written once) and
    operations of one call of a split-CG entry on this call's data: the
    live rows only, the points they observe, the keyframes."""
    rows = c["W_obs"].index.offsets if "W_obs" in c else None
    K = c["free"].shape[0]
    if name == "ba_cg_update":
        # Minv, r, x, p, ap and free read; x, r, z and a scalar written
        return K * (144 + 4 * 24 + 1) + K * 72 + 12, {"f32": 78 * K}
    L = int(rows[-1])
    Q = rows.shape[0] - 1
    S = c["obs_pt"].numel()
    if name == "ba_cg_ut":
        # live rows, their slots, the index, free, z and p_prev read; p and
        # U^T p written; 18 FMAs a live row and the direction's 12
        return (L * 76 + (Q + 1) * 4 + K * 49 + Q * 12,
                {"f32": 30 * L, "int32": 4 * L})
    # ap: place (every slot), obs_pt and the row of a live slot, G and the
    # vector of the observed points, Hpp_d, p, free read; A p and p.Ap
    # written; 27 FMAs a live slot
    n_pts = int(torch.unique(c["obs_pt"][c["obs_ok"]]).numel())
    return (S * 4 + L * 76 + n_pts * 48 + K * (144 + 24 + 1) + K * 24 + 4,
            {"f32": 27 * L + 42 * K, "int32": 3 * S})


def run_sharded_phase(rec, k6_call, device, tmp):
    """Phase 3n. (a) World size 1 over NCCL on cuda:0: `dryrun`'s problem
    and cell F's first global BA through `sharded_ba_solve` (the split CG:
    `ba_cg_ut`, `ba_cg_ap`, `ba_cg_update`, three launches a CG iteration),
    every launch counter set to 0 just before and read just after; each
    held to its plain solve in f64 at `check_gba`'s gate, with the bf16
    control outside it. (b) Two gloo ranks on cuda:0 (`run_two_ranks`):
    costs and points bit-equal on both, poses within the gate of (a)'s.
    (c) Each entry against its plain version on the calls of one sharded
    CG on cell F's first LM iteration (`entry_readings`). (d) That CG's
    CUDA-event time beside K6's one launch on the same arguments, its
    launches and collectives a CG iteration and the collectives' host ms;
    the device times of both and of each entry in a child process
    (`sharded_device_times`)."""
    import torch.distributed as dist

    from orb_slam2_refactored_tpu_torch import kernels
    from orb_slam2_refactored_tpu_torch.optim import ba
    from orb_slam2_refactored_tpu_torch.parallel import distributed

    t0 = time.perf_counter()
    probs = sharded_problems(rec, device)
    distributed.initialize(f"localhost:{free_port()}", 1, 0)
    assert dist.get_backend() == "nccl", dist.get_backend()
    world = dist.group.WORLD
    out, ws1 = {}, {}
    kernels.reset_counts()
    for name, sa in probs.items():
        t1 = time.perf_counter()
        ws1[name] = solve_sharded(sa, world)
        torch.cuda.synchronize()
        out[name] = {"wall_s": time.perf_counter() - t1}
    launches = kernels.counts()
    calls, host_s = collectives_read()
    print(f"  phase 3n (a) world size 1 (NCCL) launches: " + json.dumps(
        {n: v for n, v in launches.items() if v}) + f"; collectives "
        f"{json.dumps(calls)}, {host_s * 1e3:.3f} ms of host time")
    for n, v in launches.items():
        if n in SHARDED_KERNELS:
            assert v > 0, f"{n} never launched in phase 3n"
        elif n == "ba_schur_cg":
            assert v == 0, "K6's one launch on the sharded path"
    for name, sa in probs.items():
        p = sa["p"]
        res_e, _ = plain_gba(sa, f64=True)
        res_b, _ = plain_gba(sa, bits=7)
        g, g_b = gba_gap(ws1[name], res_e, p), gba_gap(res_b, res_e, p)
        out[name].update(vs_f64=g, bf16_vs_f64=g_b,
                         cost=(float(ws1[name].initial_cost),
                               float(ws1[name].final_cost)))
        print(f"  {name}: world size 1 vs f64: rot {g[0]:.3g} rad trans "
              f"{g[1]:.3g} m points {g[2]:.3g} m, costs {g[3]:.10g} / "
              f"{g[4]:.10g}; within the gate {gba_within(g)}; bf16 inputs "
              f"within it {gba_within(g_b)}")
        assert gba_within(g), (name, g)
        assert not gba_within(g_b), (name, g_b)
        assert float(ws1[name].final_cost) < float(ws1[name].initial_cost)

    # (b) two ranks on the one card, gloo
    t1 = time.perf_counter()
    ranks = run_two_ranks(probs, tmp)
    out["two_ranks_wall_s"] = time.perf_counter() - t1
    r0, r1 = ranks
    print(f"  phase 3n (b) {SHARDED_RANKS} gloo ranks on cuda:0 (gloo takes "
          "the CUDA tensors of all three collectives): launches "
          f"{json.dumps(r0['launches'])}, collectives {json.dumps(r0['calls'])}"
          f", {r0['host_s'] * 1e3:.1f} ms of host time (rank 0)")
    assert all(r0["calls"][n] > 0 for n in ("all_reduce", "reduce_scatter",
                                            "all_gather")), r0["calls"]
    for name, sa in probs.items():
        a, b = r0[name], r1[name]
        same = all(torch.equal(a[k], b[k]) for k in ("c0", "c1", "pt_pos",
                                                     "kf_pose"))
        res = ba.BAResult(a["kf_pose"].to(device), a["pt_pos"].to(device),
                          a["c0"], a["c1"], None)
        g = gba_gap(res, ws1[name], sa["p"])
        out[name].update(two_ranks_bit_equal=same, two_ranks_vs_ws1=g,
                         two_ranks_wall_s=a["wall_s"])
        print(f"  {name}: ranks bit-equal (costs, points, poses) {same}; "
              f"vs world size 1: rot {g[0]:.3g} trans {g[1]:.3g} points "
              f"{g[2]:.3g}, costs {g[3]:.10g} / {g[4]:.10g}; within the "
              f"gate {gba_within(g)}")
        assert same and gba_within(g), (name, same, g)
    for n in SHARDED_KERNELS:
        assert r0["launches"][n] > 0, r0["launches"]

    # (c) the entries on the calls of one sharded CG (cell F, LM 0)
    comm = ba.ShardComm(world, k6_call["G"].shape[0])
    entry_calls = {n: [] for n in SHARDED_KERNELS}
    with contextlib.ExitStack() as stack:
        for n in SHARDED_KERNELS:
            stack.enter_context(recording(entry_calls[n], (ba, n)))
        ba.sharded_cg_solve(**k6_call, comm=comm)
    readings, firsts = entry_readings(entry_calls)
    del entry_calls

    # (d) device time of the sharded CG beside K6's one launch
    it = k6_call["cg_iters"]
    kernels.reset_counts()
    ba.sharded_cg_solve(**k6_call, comm=comm)
    torch.cuda.synchronize()
    per_call = {n: kernels.counts()[n] for n in SHARDED_KERNELS}
    coll, host_s = collectives_read()
    host_ms = host_s * 1e3
    split_card = cuda_time_ms(lambda: ba.sharded_cg_solve(**k6_call,
                                                          comm=comm), 5)
    k6_card = cuda_time_ms(lambda: ba.ba_schur_cg(**k6_call), 5)
    dist.destroy_process_group()
    dev = sharded_device_times(k6_call, firsts, tmp)
    split_ms, split_rows = dev["split"]
    k6_ms, k6_rows = dev["k6"]
    for n in SHARDED_KERNELS:
        readings[n] += (dev[n][0],)
    out["cg"] = {"cg_iters": it, "launches": per_call,
                 "launches_a_cg_iteration": sum(per_call.values()) / it,
                 "collectives": coll,
                 "collectives_a_cg_iteration": sum(coll.values()) / it,
                 "collectives_host_ms": host_ms,
                 "collective_host_ms_each": host_ms / max(sum(coll.values()),
                                                          1),
                 "device_ms_split": split_ms, "device_ms_k6": k6_ms,
                 "card_ms_split": split_card, "card_ms_k6": k6_card}
    print(f"  phase 3n (d) one LM iteration's CG (cell F, {it} CG "
          f"iterations, world size 1): split {split_ms:.4f} ms of device "
          f"time ({split_card:.4f} ms CUDA events), K6's one launch "
          f"{k6_ms:.4f} ms ({k6_card:.4f}); launches {json.dumps(per_call)}, "
          f"collectives {json.dumps(coll)} ({host_ms:.3f} ms of host time); "
          f"split rows: {split_rows}; K6 rows: {k6_rows}; entries' device "
          "ms a call: " + ", ".join(f"{n} {dev[n][0]:.5f}"
                                    for n in SHARDED_KERNELS))
    assert all(v == it + 1 for v in per_call.values()), per_call
    # world size 1: the points do not shard, so U^T p is an all_reduce:
    # three a CG iteration, r.z of the setup and U^T dp
    assert coll == {"all_reduce": 3 * it + 2, "reduce_scatter": 0,
                    "all_gather": 0}, coll
    out["wall_s"] = time.perf_counter() - t0
    print("phase 3n: " + json.dumps(out, default=str))
    return readings, launches, out


# ---------------------------------------------------------------------------
# phase 3p: the bench's ingest (`bench.py:98-198`, `:618-620`, `:678-680`,
# `:758-777`): log8 depth at subsample 8 decoded by K10, the upload pool,
# pair / chain / batch stepping, `sync_device`, `warm_stage_programs`
# ---------------------------------------------------------------------------

# the RGB-D segment's ingest modes (`bench.py:153-198`): frames a step call,
# frames an upload
INGEST_MODES = {"uploaded": (1, 1), "pair": (2, 1), "chain4": (4, 1),
                "batch4_mode4": (4, 4)}
# the stereo segment's modes (`bench.py:758-777`, depth 3): per pair and in
# pairs (the 2-chain) held to the 3 cm gate; in chains of 4 recorded, not
# held: 3.021 cm on the H100, where both packages read 2.53 on the CPU and
# a last-bit change of the pyramid moves the card's reading (PERF.md §6,
# ROADMAP.md §C, C16)
STEREO_GATED = ("uploaded", "pair")
STEREO_RECORDED = ("chain4",)
# the codec's gate against the raw run (`tests/test_codec.py:99-100`)
DCT_ATE_MARGIN_M = 0.012


def ingest_gates(launches, tag, images, buffers, stereo):
    """Every kernel of the path launched (K10 once an uploaded buffer where
    it decodes, else never), none of the others."""
    for k, v in launches.items():
        if k == WIRE_KERNEL:
            assert v == buffers, (tag, k, v, buffers)
        elif k in (LARGE_KERNEL, LEARNED_KERNEL) + LOOP_KERNELS \
                + SHARDED_KERNELS or (k == "stereo_sad" and not stereo):
            assert v == 0, f"{k} launched on {tag}"
        else:
            assert v > 0, f"kernel {k} never launched on {tag}"
    assert launches["fast"] == launches["orb_desc"] == images, launches
    extraction_launches(launches, images, tag)
    if stereo:  # one B9 launch a pair
        assert launches["stereo_sad"] == images // 2, launches


def run_ingest(first, second, gt, device, mode, stereo=False, warm=False,
               gated=True, **kw):
    """Cell A's frames (or, with `stereo`, cell C's pairs) through one of
    the bench's ingest modes: every frame packed and uploaded by the
    tracker's pool (`prefetch_rgbd`, `prefetch_rgbd_batches` or
    `prefetch_stereo`), then stepped per frame, in pairs, in chains of 4 or
    in [4, B] batches in mode 4, each step call timed on a synchronizing
    host clock. The launch counters are set to 0 just before the uploads
    and read after the flush. With `warm`, `warm_stage_programs` and
    `sync_device` afterwards, as the bench calls them, must leave the map,
    the counters and the trajectory as they were. Gates: ATE <= 3 cm
    (recorded only where `gated` is false), no frame lost, the launch
    gates (`ingest_gates`)."""
    from orb_slam2_refactored_tpu_torch import convert, kernels
    from orb_slam2_refactored_tpu_torch.io.evaluation import ate_rmse
    from orb_slam2_refactored_tpu_torch.slam import tracking
    from orb_slam2_refactored_tpu_torch.utils.timing import StageTimer

    per_step, per_upload = INGEST_MODES[mode]
    cfg = (pipelined(bench_config(True), PIPE_DEPTHS["C"]) if stereo
           else ingest_config(**kw))
    tag = (f"3p {'stereo' if stereo else 'RGB-D'} {mode}"
           + "".join(f" {k}={v}" for k, v in kw.items()))
    tracker = tracking.Tracker(cfg, device=device)
    n = len(first)
    second = second if stereo else [d.astype(np.float32) for d in second]
    pack = (partial(tracking.pack_stereo, cfg) if stereo
            else partial(tracking.pack_rgbd, cfg))
    t0 = time.perf_counter()
    nbytes = sum(pack(first[i], second[i]).nbytes for i in range(n)) / n
    pack_ms = (time.perf_counter() - t0) * 1e3 / n
    kernels.reset_counts()
    tracker.sync_device()
    t0 = time.perf_counter()
    if stereo:
        futs = tracker.prefetch_stereo(first, second)
    elif per_upload == 1:
        futs = tracker.prefetch_rgbd(first, second)
    else:
        futs = tracker.prefetch_rgbd_batches(first, second, per_upload)
    bufs = [f.result() for f in futs]
    torch.cuda.synchronize()
    upload_ms = (time.perf_counter() - t0) * 1e3 / n
    assert all(b.device == device for b in bufs), "an upload missed the card"
    one = tracker.track_stereo_uploaded if stereo \
        else tracker.track_rgbd_uploaded
    chain = tracker.track_stereo_chain_uploaded if stereo \
        else tracker.track_rgbd_chain_uploaded
    pair = tracker.track_stereo_pair_uploaded if stereo \
        else tracker.track_rgbd_pair_uploaded
    timer = StageTimer(device)  # synchronizes the card at both ends
    sizes, i = [], 0
    while i < n:
        k = min(per_step, n - i)
        ts = [(i + j) / 30.0 for j in range(k)]
        if per_upload > 1:
            call = partial(tracker.track_rgbd_batch, None, None, ts,
                           uploaded=bufs[i // per_upload], mode=per_step)
        elif k == 1:
            call = partial(one, bufs[i], ts[0])
        elif k == 2:
            call = partial(pair, bufs[i], bufs[i + 1], *ts)
        else:
            call = partial(chain, bufs[i:i + k], ts)
        timed_frame(timer, tracker, call)
        sizes.append(k)
        i += k
    tracker.flush()
    launches = kernels.counts()
    if warm:
        before = (convert.map_to_numpy(tracker.map), tracker.mp_vis_dev.clone(),
                  tracker.mp_found_dev.clone(), tracker.mp_seen_dev.clone(),
                  np.stack(tracker.trajectory))
        t1 = time.perf_counter()
        tracker.warm_stage_programs()
        warm_s = time.perf_counter() - t1
        tracker.sync_device()
        after = convert.map_to_numpy(tracker.map)
        assert all(np.array_equal(after[k], v, equal_nan=True)
                   for k, v in before[0].items()), "warm moved the map"
        assert all(torch.equal(a, b) for a, b in zip(before[1:4], (
            tracker.mp_vis_dev, tracker.mp_found_dev, tracker.mp_seen_dev)))
        assert np.array_equal(before[4], np.stack(tracker.trajectory))
    est = np.stack(tracker.trajectory)
    assert est.shape == gt.shape and np.isfinite(est).all()
    ate, _ = ate_rmse(est, gt, align="se3")
    lost = sum(1 for t in tracker.track_info if t.get("lost"))
    per_frame = np.asarray([s / k for s, k in zip(timer.samples["step"],
                                                   sizes)]) * 1e3
    w = WARMUP_FRAMES // per_step
    calls = np.asarray(timer.samples["step"][w:])
    stats = {
        "path": tag, "frames": n, "ate_m": ate, "lost_frames": lost,
        "keyframes_created": 1 + sum(1 for t in tracker.track_info
                                     if t.get("kf")),
        "bytes_per_frame": nbytes, "pack_host_ms_per_frame": pack_ms,
        "upload_host_ms_per_frame": upload_ms, "buffers": len(bufs),
        "step_ms_median_per_frame": float(np.median(per_frame[w:])),
        "step_ms_p90_per_frame": float(np.percentile(per_frame[w:], 90)),
        "fps_after_warmup": float(sum(sizes[w:]) / calls.sum()),
        "use_ref_wait_ms_median": float(
            np.median(tracker.use_ref_waits) * 1e3),
        "pumps_not_ready": tracker.pumps_not_ready, "launches": launches}
    if warm:
        stats["warm_stage_programs_s"] = warm_s
    print(f"main path ({tag}) " + json.dumps(stats))
    if gated:
        assert ate <= ATE_GATE_M, f"{tag}: ATE {ate} m above the gate"
    assert lost == 0, f"{tag}: {lost} frames lost"
    decodes = not stereo and (cfg.depth_encoding == "log8"
                              or cfg.image_encoding == "dct")
    ingest_gates(launches, tag, n * (2 if stereo else 1),
                 len(bufs) if decodes else 0, stereo)
    return stats


def run_ingest_phase(imgs, depths, gt, left, right, device, wire, card):
    """Phase 3p: cell A's 120 frames at the bench's setting (log8 at
    subsample 8, pipelined at depth 6) once per ingest mode, then with the
    DCT image (per frame) under JAX's codec gates against the raw run;
    cell C's pairs through `prefetch_stereo` in the bench's three stereo
    modes (depth 3; per pair and in pairs gated, chains of 4 recorded:
    STEREO_RECORDED); cell G's two
    mono laps through `prefetch_mono` (depth 6, cell G's
    gates). `wire` is phase 2's and 5's K10 readings; each mode's row
    prints K10's on that mode's buffer shape."""
    runs = {}
    for mode in ("uploaded", "pair", "chain4", "batch4_mode4"):
        runs[mode] = run_ingest(imgs, depths, gt, device, mode,
                                warm=mode == "uploaded")
    runs["dct"] = run_ingest(imgs, depths, gt, device, "uploaded",
                             image_encoding="dct")
    raw, dct = runs["uploaded"]["ate_m"], runs["dct"]["ate_m"]
    print(f"3p DCT against raw: ATE {dct:.7f} m against {raw:.7f} m "
          f"(gates < {ATE_GATE_M} m and < raw + {DCT_ATE_MARGIN_M} m)")
    assert dct < ATE_GATE_M and dct < raw + DCT_ATE_MARGIN_M, (dct, raw)
    for mode in STEREO_GATED + STEREO_RECORDED:
        runs[f"stereo_{mode}"] = run_ingest(
            left, right, gt, device, mode, stereo=True,
            gated=mode in STEREO_GATED)
    runs["mono"] = run_mono_orbit(imgs, gt, device, depth=PIPE_DEPTHS["G"],
                                  uploaded=True)[0]
    print(f"phase 3p ({card}; host clock around torch.cuda.synchronize(), "
          f"after {WARMUP_FRAMES} warm-up frames; K10 from phases 2 and 5 "
          f"on the mode's buffer; bound = bytes / 3.35 TB/s):")
    keys = ("ate_m", "lost_frames", "bytes_per_frame",
            "pack_host_ms_per_frame", "upload_host_ms_per_frame",
            "step_ms_median_per_frame", "step_ms_p90_per_frame",
            "fps_after_warmup")
    for name, st in runs.items():
        if name == "mono":
            row = {k: st[k] for k in ("ate_sim3_m", "lost_frames",
                                      "step_ms_median", "step_ms_p90")}
        else:
            row = {k: st[k] for k in keys}
            w = None
            if not name.startswith("stereo"):
                w = wire[("dct" if name == "dct" else "log8")
                         + ("_batch4" if name == "batch4_mode4" else "")]
            if w is not None:
                row.update(k10_ms=w[1], k10_device_ms=w[5],
                           k10_bound_ms=bound_ms(w[3], w[4])[0],
                           k10_plain_ms=w[2],
                           k10_launches=st["launches"][WIRE_KERNEL])
        print(f"  {name}: " + json.dumps(row))
    return runs


@contextlib.contextmanager
def reads_at_once():
    """Every `Readback` resolved when it is first asked whether it landed,
    as on the CPU: the pipelined schedule of a CPU run, on the card."""
    from orb_slam2_refactored_tpu_torch.utils.readback import Readback

    done = Readback.done

    def landed(self):
        self.result()
        return True

    Readback.done = landed
    try:
        yield
    finally:
        Readback.done = done


def run_ingest_schedule(imgs, depths, gt, left, right, device, card):
    """`--ingest`: cell C's pairs in each of the bench's stereo modes
    (`bench.py:758-777`: per pair, pairs, chains of 4; depth 3) and cell
    A's frames at the bench's RGB-D setting per frame and in chains of 4,
    and per frame with the DCT image,
    each with the mapper's reads taken as they land and with every read
    resolved at once (`reads_at_once`, the CPU's schedule); then the
    stereo modes under K8's two other orders (`k8_order`). The ATE gate is
    recorded, not held. Tells the card's schedule apart from its numerics,
    and measures how far a last-bit change moves each mode's ATE."""
    table = []
    for name, mode in (("stereo", "uploaded"), ("stereo", "pair"),
                       ("stereo", "chain4"), ("rgbd_log8", "uploaded"),
                       ("rgbd_log8", "chain4"), ("rgbd_dct", "uploaded")):
        kw = {"image_encoding": "dct"} if name == "rgbd_dct" else {}
        for at_once in (False, True):
            with reads_at_once() if at_once else contextlib.nullcontext():
                if name == "stereo":
                    st = run_ingest(left, right, gt, device, mode,
                                    stereo=True, gated=False)
                else:
                    st = run_ingest(imgs, depths, gt, device, mode,
                                    gated=False, **kw)
                table.append({
                    "input": name, "mode": mode, "reads_at_once": at_once,
                    **{k: st[k] for k in ("ate_m", "keyframes_created",
                                          "lost_frames", "pumps_not_ready",
                                          "step_ms_median_per_frame")}})
                print("ingest schedule " + json.dumps(table[-1]))
    for order in K8_ORDERS[1:]:
        for mode in ("uploaded", "pair", "chain4"):
            with k8_order(order):
                st = run_ingest(left, right, gt, device, mode, stereo=True,
                                gated=False)
            table.append({
                "input": "stereo", "mode": mode, "k8_order": order,
                **{k: st[k] for k in ("ate_m", "keyframes_created",
                                      "lost_frames", "pumps_not_ready")}})
            print("ingest schedule " + json.dumps(table[-1]))
    print(f"ingest schedule ({card}): gate {ATE_GATE_M} m recorded, not held")
    return table


# ---------------------------------------------------------------------------
# phase 3o: the live viewer beside cell A
# ---------------------------------------------------------------------------

VIEWER_HZ = 2.0
# the viewer's cost to the step: ticks 1 ms apart, a render as soon as the
# last ends, so that tens of renders overlap the run's ~1.2 s of steps
VIEWER_HZ_BUSY = 1000.0
AR_MIN_OBS = 2  # tests/test_ar_live.py: a short map tops out at few views
AR_RED_PIXELS = 50  # tests/test_ar_live.py:130-133


def run_viewer_phase(imgs, depths, gt, device, stats_a, tmp):
    """Phase 3o: cell A's 120 frames again, first without a viewer (the
    control: the same point in the run), then with a `LiveViewer` at 2 Hz
    on the tracker: the same ATE bits as cell A, `map_latest.png` decoding
    through `io/png.py`, `status.json` OK, at least one tick rendered while
    tracking; the render's host ms a tick and the step's median and p90
    beside cell A's and the control's; then `ArOverlay` on the last frame:
    a plane found and the cube drawn (more than 50 red pixels). Then the
    viewer's cost: the same frames with the viewer rendering back to back
    (VIEWER_HZ_BUSY), the same ATE bits, and the step's median and p90 of
    the frames that overlapped a render beside those of the frames apart
    from one and the control's."""
    from orb_slam2_refactored_tpu_torch.io.png import read_png
    from orb_slam2_refactored_tpu_torch.viz.ar import ArOverlay

    ctrl, _ = run_main_path(imgs, depths, gt, device, local_ba=True,
                            label="the viewer's control")
    out_dir = os.path.join(tmp, "viz_live")
    stats, tracker = run_main_path(imgs, depths, gt, device, local_ba=True,
                                   label="viewer at 2 Hz",
                                   viewer_dir=out_dir)
    v = stats.pop("viewer")
    busy, _ = run_main_path(imgs, depths, gt, device, local_ba=True,
                            label="viewer rendering back to back",
                            viewer_dir=os.path.join(tmp, "viz_busy"),
                            viewer_hz=VIEWER_HZ_BUSY)
    busy_v = busy.pop("viewer")
    img = read_png(os.path.join(out_dir, "map_latest.png"))
    status = json.load(open(os.path.join(out_dir, "status.json")))
    ar = ArOverlay(tracker, min_obs=AR_MIN_OBS)
    found = ar.insert_cube(size=0.3)
    red = 0
    if found:
        over = ar.render(imgs[-1])
        red = int(((over[..., 0].astype(int) - over[..., 2].astype(int))
                   > 100).sum())
    res = {"ate_m": stats["ate_m"], "ate_m_cell_a": stats_a["ate_m"],
           "step_ms_median": stats["step_ms_median"],
           "step_ms_p90": stats["step_ms_p90"],
           "step_ms_median_cell_a": stats_a["step_ms_median"],
           "step_ms_p90_cell_a": stats_a["step_ms_p90"],
           "step_ms_median_control": ctrl["step_ms_median"],
           "step_ms_p90_control": ctrl["step_ms_p90"],
           **v, "png_shape": list(img.shape), "status": status,
           "ar_plane": found, "ar_red_pixels": red,
           "busy": {"hz": VIEWER_HZ_BUSY,
                    "step_ms_median": busy["step_ms_median"],
                    "step_ms_p90": busy["step_ms_p90"], **busy_v}}
    print("phase 3o: " + json.dumps(res))
    assert (stats["ate_m"] == ctrl["ate_m"] == stats_a["ate_m"]
            == busy["ate_m"]), (stats["ate_m"], ctrl["ate_m"],
                                stats_a["ate_m"], busy["ate_m"])
    assert busy_v["frames_overlapping"] > 0, busy_v
    assert img.shape == (800, 800, 3), img.shape
    assert status["state"] == 1, status
    assert v["ticks_rendered"] >= 1, v
    assert found and red > AR_RED_PIXELS, (found, red)
    return res


def kernel_row(name, src, rep, launches, r, library_ms=None):
    b_ms, b_by = bound_ms(r[3], r[4])
    return {"name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches, "max_abs_err": float(r[0]), "ms": r[1],
            "plain_ms": r[2], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms,
            "device_ms": r[5] if len(r) > 5 else None}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="after the main paths, break a frame's time down "
                    "(cell A's, and a stereo frame's of cell C)")
    ap.add_argument("--parent", metavar="DIR",
                    help="also hold K1, K4, K5, B9, K6, K8, K9, K7, B6 and R "
                    "(and cell F's global BA, the projection and "
                    "motion-model searches) against the kernels of the "
                    "checkout in DIR (outputs, device and CUDA-event time, "
                    "the wrappers' host time, in turns)")
    ap.add_argument("--time-side", choices=("parent", "change"),
                    help="with --parent and --jobs: only time the recorded "
                    "jobs through one side's kernels (a process of its own, "
                    "started by --parent)")
    ap.add_argument("--jobs", metavar="FILE", help=argparse.SUPPRESS)
    # one rank of phase 3n (b), started by the script itself
    ap.add_argument("--sharded-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--coord", help=argparse.SUPPRESS)
    # phase 3n's device times, started by the script itself
    ap.add_argument("--sharded-times", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--arena", action="store_true",
                    help="only measure the C++ map-graph arena beside the "
                    "Python graph (cells A, E and F), recording the loop "
                    "cells' gates without holding them; with --c13, run "
                    "--c13's cells on the arena")
    ap.add_argument("--c13", action="store_true",
                    help="only run cells E and F, loop closing off and on, "
                    "under three orders of K8's partial sums (the GEMM's, "
                    "one chain, 8-wide blocks), recording the ATE and the "
                    "gates without holding them")
    ap.add_argument("--ingest", action="store_true",
                    help="only run phase 3p's stereo modes and two RGB-D "
                    "modes with the mapper's reads as they land and "
                    "resolved at once (the CPU's schedule), recording the "
                    "ATE gate without holding it")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    if args.time_side:
        time_side(args.time_side, args.parent, args.jobs)
        return
    if args.sharded_rank is not None:
        sharded_rank_main(args.sharded_rank, args.world, args.coord,
                          args.jobs)
        return
    if args.sharded_times:
        sharded_times_main(args.jobs)
        return
    if args.arena and not args.c13:
        from orb_slam2_refactored_tpu_torch import kernels

        card = card_line()
        print(card)
        kernels.build_all()
        table = run_arena(torch.device("cuda:0"), card)
        print(card)
        print(json.dumps({"arena": table}))
        return
    if args.ingest:
        from orb_slam2_refactored_tpu_torch import kernels

        card = card_line()
        print(card)
        kernels.build_all()
        imgs, depths, gt = bench_frames(N_FRAMES)
        left, right = bench_stereo_frames(gt)
        table = run_ingest_schedule(imgs, depths, gt, left, right,
                                    torch.device("cuda:0"), card)
        print(card)
        print(json.dumps({"ingest": table}))
        return
    if args.c13:
        from orb_slam2_refactored_tpu_torch import kernels

        card = card_line()
        print(card)
        kernels.build_all()
        with native_graph() if args.arena else contextlib.nullcontext():
            table = run_c13(torch.device("cuda:0"))
        print(card)
        print(json.dumps({"c13": table}))
        return

    from orb_slam2_refactored_tpu_torch import kernels
    from orb_slam2_refactored_tpu_torch.ops import image as image_ops
    from orb_slam2_refactored_tpu_torch.ops.orb import OrbExtractor

    device = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # wall time of each phase and of the loop cells' longest steps
    wall, t_phase = {}, time.perf_counter()

    def mark(name, since=None):
        nonlocal t_phase
        now = time.perf_counter()
        wall[name] = now - (t_phase if since is None else since)
        if since is None:
            t_phase = now

    # ---- phase 1: card, toolchain, build ----
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(sh([kernels.nvcc_path(), "--version"]).splitlines()[-1])
    t0 = time.perf_counter()
    logs = kernels.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "ptxas" in line or "spill" in line:
                print(f"  [{name}] {line.strip()}")

    mark("1_build")
    # ---- phase 2: K2, K3 and the fallback branch ----
    t0 = time.perf_counter()
    imgs, depths, gt = bench_frames(N_FRAMES)
    print(f"{N_FRAMES} VGA frames rendered in {time.perf_counter() - t0:.1f} s")
    cfg = bench_config(True)
    t0 = time.perf_counter()
    ext = OrbExtractor(480, 640, cfg.n_features, cfg.scale_factor,
                       cfg.n_levels, device=device)  # K8's, K9's tables
    torch.cuda.synchronize()
    t_plan = time.perf_counter() - t0
    img0 = torch.as_tensor(imgs[0], device=device)
    gray0 = image_ops.to_gray(img0)
    pyr_r, pyr_lib_ms, pyr_lib = check_pyramid(
        gray0, imgs, cfg.n_levels, cfg.scale_factor, t_plan)
    levels = image_ops.build_pyramid(gray0, cfg.n_levels, cfg.scale_factor)
    fast_r = check_fast(levels, ext.budgets, "frame 0", timed=True)
    topk_r, topk_lib_ms, topk_lib = check_topk(
        levels, ext.budgets, ext.level_scales, "frame 0", timed=True)
    kp0 = level_keypoints(levels, ext.budgets)
    orb_r = check_orb(levels, *kp0, ext.budgets, "frame 0", timed=True)
    fb_k1, fb_k4 = check_fallback(imgs, depths, gt, device)
    wire, wire_lib = check_wire(imgs, depths, device)

    mark("2_k8_k2_k9_k3_fallback_k10")
    # ---- phase 3: the main paths ----
    # no frame builds K8's, K9's or K7's tables: each tracker built them when
    # constructed
    main_paths = contextlib.ExitStack()
    plan_builds = main_paths.enter_context(counting_plan_builds([0]))
    n = N_FRAMES_NO_BA
    run_main_path(imgs[:n], depths[:n], gt[:n], device, local_ba=False)
    stats, tracker = run_main_path(imgs, depths, gt, device, local_ba=True)
    kf_loop_ms(tracker, "cell A")
    stats_d, tracker_d, rec_d = run_kidnap(imgs, depths, gt, device)
    kf_loop_ms(tracker_d, "cell D")
    t0 = time.perf_counter()
    left, right = bench_stereo_frames(gt)
    print(f"{N_FRAMES} VGA stereo pairs rendered in "
          f"{time.perf_counter() - t0:.1f} s")
    stats_c, tracker_c = run_main_path(left, right, gt, device,
                                       local_ba=True, stereo=True)
    # cells E and F: the loop-closing circuits, loop closing off and on;
    # cell F's global BA and pose graph recorded for phases 4 and 5
    mark("3_cells_a_to_d")
    loop_cells, loop_checks = {}, {}
    for cell in ("E", "F"):
        t0 = time.perf_counter()
        frames, cgt = circuit_frames(cell)
        print(f"cell {cell}: {len(frames)} frames rendered in "
              f"{time.perf_counter() - t0:.1f} s")
        off, _ = run_circuit(cell, False, frames, cgt, device)
        rec_f = {} if cell == "F" else None
        loop_checks[cell] = []
        on, _ = run_circuit(cell, True, frames, cgt, device, record=rec_f,
                            loop_checks=loop_checks[cell])
        gate_loop_cell(on, off)
        loop_cells[cell] = (off, on)
        if cell == "F":
            frames_f, gt_f = frames, cgt  # phase 3m's F-pipe
        del frames
        mark(f"3_cell_{cell}")
    # cells G and H: the mono slice (the bench's orbit through track_mono;
    # the mono circuit with loop closing)
    stats_g, tracker_g, boot_g = run_mono_orbit(imgs, gt, device)
    mark("3_cell_G")
    t0 = time.perf_counter()
    frames_h, gt_h = mono_circuit_frames()
    print(f"cell H: {len(frames_h)} frames rendered in "
          f"{time.perf_counter() - t0:.1f} s")
    stats_h = run_mono_circuit(frames_h, gt_h, device)
    del frames_h
    mark("3_cell_H")
    # cell I: the facade through the CLI (settings file, TUM reader, the
    # three savers) with the learned pattern (K7); phase 3j: the
    # stereo_kitti and mono_tum CLIs
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    atexit.register(shutil.rmtree, tmp, True)
    stats_i, system_i, seq_i = run_cell_i(imgs, depths, gt, tmp)
    mark("3_cell_I")
    drivers_3j = run_driver_cells(tmp)
    mark("3_j_drivers")
    # phase 3k: cameras past VGA, tracked; then K8, K2, K9 and K3 held
    # against their plain versions there
    geo_runs, geo_frames = {}, {}
    for h, w in GEOMETRY_RUNS:
        geo_runs[(h, w)], geo_frames[(h, w)] = run_geometry(h, w, device)
    main_paths.close()
    print(f"phase 3: K8, K9 and K7 calls that built their tables on a frame "
          f"{plan_builds[0]}")
    assert plan_builds[0] == 0, "a frame built K8's, K9's or K7's tables"
    geo_checks, large_r = {}, None
    for h, w in GEOMETRY_CHECKS:
        frames = geo_frames.get((h, w))
        if frames is None:
            frames = geometry_frames(h, w, 2)[0]
        geo_checks[(h, w)], got = check_geometry(h, w, frames, device)
        if (h, w) == (2160, 3840):
            large_r = got
    del geo_frames
    mark("3_k_geometries")

    # ---- phase 4: every kernel on the arguments the main path gave it ----
    from orb_slam2_refactored_tpu_torch.ops import hamming, matching

    sbp, frame_claims, mm_a, mm_c, mm_g = [], [], [], [], []
    mm_rec = (matching, "search_last_frame_mapped")
    with recording(sbp, (matching, "search_by_projection_with_vis")), \
            recording(frame_claims, (hamming, "resolve_duplicates")), \
            recording(frame_claims, (hamming, "resolve_rows")), \
            recording(mm_a, mm_rec):
        (frame_k1, frame_k2, frame_k3, frame_k4,
         frame_k9) = record_tracked_frame(tracker, imgs, depths)
    # the motion-model search's R call (rows mode) comes first
    assert len(sbp) == len(mm_a) == 1 and "max_dist" in frame_claims[0], (
        len(sbp), len(mm_a), len(frame_claims))
    check_fast(frame_k2["levels"], frame_k2["ks"], "tracked frame")
    check_topk(frame_k2["levels"], frame_k2["ks"], ext.level_scales,
               "tracked frame")
    check_orb(frame_k3["levels"], frame_k3["ys"], frame_k3["xs"],
              frame_k3["counts"], "tracked frame")
    frame_k1 = name_k1_calls("tracked", frame_k1)
    frame_k4 = {f"tracked{i}": a for i, a in enumerate(frame_k4)}
    claim_calls = []
    tri_k1, asm_call, solve_call = record_mapping(tracker, claim_calls)
    ham_r = check_hamming({**frame_k1, **name_k1_calls("fallback", fb_k1),
                           **name_k1_calls("triangulation", tri_k1)},
                          per_frame=frame_k1)
    pose_r = check_pose_lm({**frame_k4, **{f"fallback{i}": a for i, a in
                                           enumerate(fb_k4)}},
                           per_frame=frame_k4)
    index_r, asm_r, cost_r = check_ba(asm_call, solve_call)
    # cell C: a tracked stereo frame's K1, K4 and B9 calls, one window BA
    with recording(mm_c, mm_rec):
        st_k1, st_k4, st_sad, st_sbp = record_tracked_stereo_frame(
            tracker_c, left, right)
    st_k1 = name_k1_calls("stereo", st_k1)
    st_pair = {n: a for n, a in st_k1.items() if n.endswith("_pair")}
    assert len(st_pair) == 1, list(st_k1)
    st_ham = check_hamming(st_k1, per_frame=st_pair)
    b_ms, b_by = bound_ms(st_ham[3], st_ham[4])
    print(f"  stereo K1 call {', '.join(st_pair)}: {st_ham[1]:.5f} ms, plain "
          f"{st_ham[2]:.5f} ms, bound {b_ms:.6f} ms ({b_by})")
    check_pose_lm({f"stereo{i}": a for i, a in enumerate(st_k4)},
                  per_frame={})
    sad_r, st_tail = check_stereo_sad(st_sad)
    _, st_asm, st_solve = record_mapping(tracker_c)
    check_ba(st_asm, st_solve)
    # cell D: the recovering frame's relocalization and the vocabulary
    reloc_shapes, reloc_k4_err = check_reloc(rec_d, tracker_d)
    # B6 and R on the projection searches the main paths made (the tracked
    # frame's, cell C's tracked stereo frame's, cell D's polish, the loop
    # checks of E and F); R on the tracked frame's motion-model search and
    # on triangulation's and fusion's claims
    assert rec_d["sbp"] and all(loop_checks.values()), (
        len(rec_d["sbp"]), {c: len(v) for c, v in loop_checks.items()})
    b6_r, frame_r = check_project_search(
        {"tracked": sbp[0], "stereo": st_sbp,
         **{f"reloc_polish{i}": a for i, a in enumerate(rec_d["sbp"])},
         **{f"loop_check_{c}{i}": a for c, calls in loop_checks.items()
            for i, a in enumerate(calls)}}, per_frame="tracked")
    claims_r = check_claims(
        {**{f"tracked{i}": a for i, a in enumerate(frame_claims)},
         **{f"mapping{i}": a for i, a in enumerate(claim_calls)}},
        per_frame=[frame_claims[0], frame_r])
    # cell F: its first global BA (K5 `w_obs`, K6) and its pose graph
    t0 = time.perf_counter()
    w_obs_r, k6_r, k6_calls, gba_call, pg_call, gba_launches = check_gba(
        rec_f, device)
    mark("4_check_gba", since=t0)
    # stereo save/load, a path of its own (after the cell-C checks above,
    # which its drain of cell C's deferred mapping products would move)
    check_stereo_save_load(tracker_c, left, right, gt, device)
    # cell G: the bootstrap's window match (K1, both passes), one more
    # tracked mono frame's K1 and K4 calls (every row mono), the
    # bootstrap's 2-keyframe window BA and a later window (K5); the mono
    # fallback (pnp_ransac); the card's initialize and pnp_ransac against
    # the CPU; C11's global BA at the full map capacity
    t0 = time.perf_counter()
    mono_win = {n: a for n, a in name_k1_calls(
        "mono_window", boot_g["k1"]).items() if "pair_ok" in a}
    win_ham = check_hamming(mono_win, per_frame=mono_win)
    with recording(mm_g, mm_rec):
        mono_k1, mono_k4 = record_tracked_mono_frame(tracker_g, imgs)
    assert len(mm_c) == len(mm_g) == 1, (len(mm_c), len(mm_g))
    # B6's feature mode and R's rows mode on the motion-model searches of
    # cells A, C and G
    feat_r = check_motion_model({"tracked": mm_a[0], "stereo": mm_c[0],
                                 "mono": mm_g[0]}, per_frame="tracked")
    mono_k1 = name_k1_calls("mono", mono_k1)
    mono_k4 = {f"mono{i}": a for i, a in enumerate(mono_k4)}
    mono_ham = check_hamming(mono_k1, per_frame=mono_k1)
    mono_pose = check_pose_lm(mono_k4, per_frame=mono_k4)
    print("  K5 on cell G's bootstrap window (2 keyframes, one fixed):")
    check_ba(boot_g["asm"][0], boot_g["solve"][0])
    _, g_asm, g_solve = record_mapping(tracker_g)
    print("  K5 on a later window of cell G:")
    check_ba(g_asm, g_solve)
    pnp_call, fb_mono_k4 = check_mono_fallback(imgs, gt, device)
    check_pose_lm({f"mono_fallback{i}": a for i, a in enumerate(fb_mono_k4)},
                  per_frame={})
    solver_err, pnp_call = check_solvers(boot_g["init"][0], pnp_call)
    c11 = check_full_map_ba(device)
    mark("4_mono_and_c11", since=t0)
    # cell I: K7 on frame 0's keypoints and on one more tracked frame's
    # call, both holds and the swapped-pair control
    t0 = time.perf_counter()
    k7_r = check_orb_learned(levels, *kp0, ext.budgets, "frame 0",
                             timed=True)
    frame_k7 = record_tracked_frame_i(system_i, seq_i)
    check_orb_learned(frame_k7["levels"], frame_k7["ys"], frame_k7["xs"],
                      frame_k7["counts"], "cell I tracked frame")
    mark("4_k7", since=t0)

    mark("4_checks")
    # ---- phase 5: profiler windows, after every agreement check ----
    from orb_slam2_refactored_tpu_torch.ops import fast, orb
    from orb_slam2_refactored_tpu_torch.ops.orb import EDGE_MARGIN

    k2_ms, k2_rows = profiled_ms(lambda: fast.detect_and_rank(
        levels, 20.0, 7.0, ext.budgets, margin=EDGE_MARGIN), 20)
    ranked0 = [(r, p) for _, r, p in fast.detect_and_rank(
        levels, 20.0, 7.0, ext.budgets, margin=EDGE_MARGIN)]
    topk_args = (ranked0, ext.budgets, [tuple(x.shape) for x in levels],
                 list(range(cfg.n_levels)), ext.level_scales)
    ext_t = {}
    for name, fn in (
            ("K8", lambda: image_ops.build_pyramid(
                gray0, cfg.n_levels, cfg.scale_factor)),
            ("plain pyramid", lambda: image_ops.build_pyramid_plain(
                gray0, cfg.n_levels, cfg.scale_factor)),
            ("K8's library call (resident GEMMs)", lambda: pyr_lib()),
            ("K9", lambda: orb.spread_topk_levels(*topk_args)),
            ("plain top-k", lambda: orb.spread_topk_levels_plain(
                *topk_args)),
            ("K9's library call (stable sort)", topk_lib)):
        n_ops = []
        ms, rows = profiled_ms(fn, 20, n_ops)
        ext_t[name] = {"device_ms": ms, "device_ops": n_ops[0]}
        print(f"{name} device time {ms:.5f} ms a call, {n_ops[0]:g} device "
              f"operations: {rows}")
    pyr_r += (ext_t["K8"]["device_ms"],)
    topk_r += (ext_t["K9"]["device_ms"],)
    for name, r in (("K8", pyr_r), ("K9", topk_r)):
        b_ms, b_by = bound_ms(r[3], r[4])
        ext_t[name].update(card_ms=r[1], plain_card_ms=r[2], bound_ms=b_ms,
                           bound_by=b_by)
    ext_t["K8's library call (resident GEMMs)"]["card_ms"] = pyr_lib_ms
    ext_t["K9's library call (stable sort)"]["card_ms"] = topk_lib_ms
    print("K8 and K9 on frame 0: " + json.dumps(ext_t))
    k3_ms, k3_rows = profiled_ms(lambda: orb.angles_and_descriptors_levels(
        levels, *kp0, ext.budgets), 20)
    k7_ms, k7_rows = profiled_ms(
        lambda: orb.angles_and_descriptors_learned_levels(
            levels, *kp0, ext.budgets), 20)
    print(f"K2 device time {k2_ms:.5f} ms a call: {k2_rows}")
    print(f"K3 device time {k3_ms:.5f} ms a call: {k3_rows}")
    print(f"K7 device time {k7_ms:.5f} ms a call: {k7_rows}")
    fast_r += (k2_ms,)
    orb_r += (k3_ms,)
    k7_r += (k7_ms,)
    b_ms, b_by = bound_ms(k7_r[3], k7_r[4])
    print(f"K7 frame 0: card {k7_r[1]:.5f} ms, device {k7_ms:.5f} ms, plain "
          f"{k7_r[2]:.5f} ms, bound {b_ms:.6f} ms ({b_by}); cell I's "
          f"tracked frame: " + json.dumps(
              {"launches": stats_i["launches"][LEARNED_KERNEL]}))
    ham_r += (device_times_k1(frame_k1),)
    pose_r += (device_times_k4(frame_k4),)
    k4_chain(frame_k4, device)
    index_r, asm_r, cost_r = device_times_k5(asm_call, index_r, asm_r,
                                             cost_r)
    from orb_slam2_refactored_tpu_torch.ops import stereo

    sad_ops = []
    sad_ms, sad_rows = profiled_ms(
        lambda: stereo.associate_from_best2(**st_tail), 20, sad_ops)
    print(f"B9 device time {sad_ms:.5f} ms a call, {sad_ops[0]:g} device "
          f"operations: {sad_rows}")
    assert sad_ops[0] == 1, sad_rows
    sad_r += (sad_ms,)
    b9_wrapper_host_us(st_tail)
    # the whole association: the gate, K1 and B9; no copy to or from the
    # host in it
    assoc_ops = []
    assoc_ms, assoc_rows = profiled_ms(
        lambda: stereo.stereo_associate(**st_sad), 20, assoc_ops)
    print(f"stereo_associate (gate, K1, B9) device time {assoc_ms:.5f} ms a "
          f"call, {assoc_ops[0]:g} device operations: {assoc_rows}")
    assert not [r for r in assoc_rows if "Memcpy" in r], assoc_rows
    print(f"stereo K1 call: {device_times_k1(st_pair):.5f} ms of device time")
    wire_device_ms(wire, imgs, depths, device)
    reloc_breakdown(rec_d, tracker_d)
    # windows of a few launches come before the one-call windows of long
    # solves (`profiled_solve`) and the tracked-frame windows: on the H100
    # the K1 windows taken after those lost 4 of 20 launches in every try
    mono_t = {}
    b_ms, b_by = bound_ms(win_ham[3], win_ham[4])
    mono_t["k1_window"] = {"card_ms": win_ham[1], "plain_ms": win_ham[2],
                           "device_ms": device_times_k1(mono_win),
                           "bound_ms": b_ms, "bound_by": b_by}
    b_ms, b_by = bound_ms(mono_pose[3], mono_pose[4])
    mono_t["k4_mono_frame"] = {"card_ms": mono_pose[1],
                               "plain_ms": mono_pose[2],
                               "device_ms": device_times_k4(mono_k4),
                               "bound_ms": b_ms, "bound_by": b_by}
    b6_r, claims_r, feat_r = b6_r_device_times(
        sbp[0], [frame_claims[0], frame_r], b6_r, claims_r, mm_a[0], feat_r)
    t0 = time.perf_counter()
    w_obs_r, k6_r, gba_t = gba_times(k6_calls, gba_call, pg_call, w_obs_r,
                                     k6_r)
    mark("5_gba_times", since=t0)
    t0 = time.perf_counter()
    frame_ops = {}
    for r in (fast_r, orb_r, mono_ham, mono_pose):
        add_ops(frame_ops, **r[4])
    mono_t.update(mono_times(boot_g["init"][0], pnp_call,
                             fast_r[3] + orb_r[3] + mono_ham[3]
                             + mono_pose[3], frame_ops))
    print("mono slice: " + json.dumps({
        **mono_t, "solvers_card_vs_cpu": solver_err, "c11_yardstick": c11,
        "G": {k: stats_g[k] for k in ("ate_sim3_m", "init_frame",
                                      "fps_measured_lap", "step_ms_median",
                                      "step_ms_p90")},
        "H": {k: stats_h[k] for k in ("ate_sim3_m", "loops_closed",
                                      "close_loop_ms")}}))
    mark("5_mono_times", since=t0)
    print("loop cells: " + json.dumps({
        c: {"ate_off_m": off["ate_m"], "ate_on_m": on["ate_m"],
            "loops": on["loops_closed"], "close_loop_ms": on["close_loop_ms"],
            "gba_merge_ms": on["gba_merge_ms"], "wall_off_s": off["wall_s"],
            "wall_on_s": on["wall_s"]}
        for c, (off, on) in loop_cells.items()}
        | {"F_global_ba": {**gba_t, "launches": gba_launches}}))
    if args.parent:
        dense_k1 = {n: a for n, a in {**name_k1_calls("fallback", fb_k1),
                                      **name_k1_calls("triangulation",
                                                      tri_k1)}.items()
                    if "uv" not in a}
        pyr_args = {"n_levels": cfg.n_levels,
                    "scale_factor": cfg.scale_factor}
        compare_with_parent(args.parent, frame_k1, dense_k1, frame_k4,
                            {f"fallback{i}": a for i, a in enumerate(fb_k4)},
                            asm_call, st_tail, k6_calls, gba_call,
                            {"frame0": {"img": gray0, **pyr_args},
                             "tracked": {"img": frame_k2["levels"][0],
                                         **pyr_args}},
                            {"frame0": dict(zip(
                                ("ranked", "ks", "shapes", "level_ids",
                                 "scales"), topk_args)),
                             "tracked": {k: v for k, v in frame_k9.items()
                                         if k != "buffers"}},
                            {"frame0": {"levels": levels, "ys": kp0[0],
                                        "xs": kp0[1],
                                        "counts": ext.budgets},
                             "cell_i_tracked": {
                                 **frame_k7,
                                 "levels": k8_layout(frame_k7["levels"])}},
                            sbp[0], [frame_claims[0], frame_r], mm_a[0])
        cell_a_against_parent(imgs, depths, gt, device)
    compare_extraction(imgs, device)
    # a tracked RGB-D frame's device operations (cell A's tracker, the
    # frames `profile_steps` profiles)
    _profile_window(tracker, lambda k: tracker.track_rgbd(
        imgs[k % N_FRAMES], depths[k % N_FRAMES].astype(np.float32)),
        range(11, 31), "tracked frames (cell A)")
    _profile_window(tracker_g, lambda k: tracker_g.track_mono(
        imgs[k % N_FRAMES]), range(1, 21), "mono tracked frames (cell G)")
    if args.profile:
        profile_steps(tracker, imgs, depths)
        _profile_window(tracker_c, lambda k: tracker_c.track_stereo(
            left[k % N_FRAMES], right[k % N_FRAMES]), range(1, 21),
            "stereo tracked frames (cell C)")

    mark("5_profiles")
    # phase 3n: the sharded global BA (world size 1 over NCCL, two gloo
    # ranks on the card), its split CG's entries against their plain
    # versions and timed (device times in a child process)
    sharded_r, sharded_launches, _ = run_sharded_phase(rec_f, k6_calls[0],
                                                       device, tmp)
    mark("3_n_sharded_ba")
    # phase 3m: the bench's pipelined segments, each beside its
    # synchronous cell. It runs after phase 5: with its ~650 frames ahead
    # of them, phase 5's profiler windows of cell D's relocalization LM lost
    # one launch of 20 in every try on the H100
    with counting_plan_builds([0]) as builds:
        pipe = run_pipelined_cells(
            imgs, depths, gt, left, right, frames_f, gt_f, device,
            {"A": stats, "C": stats_c, "G": stats_g,
             "F": loop_cells["F"][1]}, card)
    del frames_f
    assert builds[0] == 0, "a pipelined frame built K8's, K9's or K7's tables"
    mark("3_m_pipelined")
    # phase 3p: the bench's ingest (log8 depth at subsample 8 through K10,
    # the upload pool, pair / chain / batch stepping, the DCT image, the
    # stereo chain, the mono prefetch)
    with counting_plan_builds([0]) as builds:
        ingest = run_ingest_phase(imgs, depths, gt, left, right, device,
                                  wire, card)
    assert builds[0] == 0, "an ingest frame built K8's, K9's or K7's tables"
    mark("3_p_ingest")
    # phase 3o: the live viewer beside cell A, and the AR cube
    run_viewer_phase(imgs, depths, gt, device, stats, tmp)
    mark("3_o_viewer")
    print("wall s: " + json.dumps(wall))
    pkg, ref = "orb_slam2_refactored_tpu_torch/csrc/", "orb_slam2_refactored_tpu/"
    L = stats["launches"]
    rows = [
        kernel_row("hamming_best2", pkg + "hamming.cu",
                   ref + "ops/hamming.py:81", L["hamming_best2"], ham_r),
        kernel_row("fast", pkg + "fast.cu", ref + "ops/fast.py:130",
                   L["fast"], fast_r),
        kernel_row("orb_desc", pkg + "orb_desc.cu", ref + "ops/orb.py:364",
                   L["orb_desc"], orb_r),
        kernel_row("pose_lm", pkg + "pose_lm.cu",
                   ref + "optim/pose_opt.py:71", L["pose_lm"], pose_r),
        kernel_row("ba_point_index", pkg + "ba_assemble.cu",
                   ref + "optim/ba.py:297", L["ba_point_index"], index_r),
        kernel_row("ba_assemble", pkg + "ba_assemble.cu",
                   ref + "optim/ba.py:272", L["ba_assemble"], asm_r),
        kernel_row("ba_cost", pkg + "ba_assemble.cu",
                   ref + "optim/ba.py:151", L["ba_cost"], cost_r),
        kernel_row("stereo_sad", pkg + "stereo_sad.cu",
                   ref + "ops/stereo.py:120",
                   stats_c["launches"]["stereo_sad"], sad_r),
        kernel_row("ba_assemble_w_obs", pkg + "ba_assemble.cu",
                   ref + "optim/ba.py:317",
                   loop_cells["F"][1]["launches"]["ba_assemble_w_obs"],
                   w_obs_r),
        kernel_row("ba_schur_cg", pkg + "ba_schur.cu",
                   ref + "optim/ba.py:349",
                   loop_cells["F"][1]["launches"]["ba_schur_cg"], k6_r),
        kernel_row(LEARNED_KERNEL, pkg + "orb_desc_learned.cu",
                   ref + "ops/orb.py:532",
                   stats_i["launches"][LEARNED_KERNEL], k7_r),
        kernel_row("pyramid", pkg + "pyramid.cu", ref + "ops/image.py:42",
                   L["pyramid"], pyr_r, pyr_lib_ms),
        kernel_row("spread_topk", pkg + "spread_topk.cu",
                   ref + "ops/orb.py:203", L["spread_topk"], topk_r,
                   topk_lib_ms),
        kernel_row(LARGE_KERNEL, pkg + "spread_topk.cu",
                   ref + "ops/orb.py:203",
                   sum(g["launches"][LARGE_KERNEL]
                       for g in geo_runs.values()), *large_r),
    ] + [kernel_row(n, pkg + "ba_schur_sharded.cu", ref + "optim/ba.py:" + line,
                    sharded_launches[n], sharded_r[n])
         for n, line in zip(SHARDED_KERNELS, ("319", "335", "349"))] + [
        kernel_row(WIRE_KERNEL, pkg + "wire_unpack.cu",
                   ref + "ops/codec.py:90",
                   ingest["dct"]["launches"][WIRE_KERNEL], wire["dct"],
                   wire_lib),
        kernel_row("project_search", pkg + "project_search.cu",
                   ref + "ops/matching.py:116", L["project_search"], b6_r),
        kernel_row("project_features", pkg + "project_search.cu",
                   ref + "ops/matching.py:246", L["project_features"],
                   feat_r),
        kernel_row("resolve_claims", pkg + "resolve_claims.cu",
                   ref + "ops/hamming.py:101", L["resolve_claims"],
                   claims_r)]
    [wire_row] = [r for r in rows if r["name"] == WIRE_KERNEL]
    wire_row.update({f"{k}_{t}": v for t in ("log8", "log8_batch4")
                     for k, v in zip(("ms", "plain_ms", "device_ms"),
                                     wire[t][1:3] + wire[t][5:])}
                    | {"bound_ms_log8": bound_ms(*wire["log8"][3:5])[0]})
    rows[3]["max_abs_err"] = max(rows[3]["max_abs_err"], reloc_k4_err)
    for row in rows:
        row["launches_cell_3k"] = sum(g["launches"][row["name"]]
                                      for g in geo_runs.values())
        row["launches_cell_d"] = stats_d["launches"][row["name"]]
        row["launches_cell_g"] = stats_g["launches"][row["name"]]
        row["launches_cell_h"] = stats_h["launches"][row["name"]]
        row["launches_cell_i"] = stats_i["launches"][row["name"]]
        row["launches_cell_3m"] = sum(c["launches"][row["name"]]
                                      for c in pipe.values())
        row["launches_cell_3p"] = sum(c["launches"][row["name"]]
                                      for c in ingest.values())
    print(f"relocalization K1 and K4 calls, and one training K1 call "
          f"(cell D): {json.dumps(reloc_shapes)}")
    print(f"per frame: K1 = {', '.join(frame_k1)}; K4 = "
          f"{', '.join(frame_k4)}; K2 and K3 = one call each over all 8 "
          "pyramid levels of frame 0; "
          "K5 = one LM iteration of one window BA (its index: once a "
          "solve); stereo_sad = the one launch after K1 of a tracked "
          "stereo frame's association, its "
          "launches from cell C; ba_assemble_w_obs = one LM iteration of "
          "cell F's first global BA; ba_schur_cg = the CG solve of one LM "
          "iteration of it (one launch: the rhs, 40 CG iterations and "
          "U^T dp), launches from cell F with loop closing on (one an LM "
          "iteration); orb_desc_learned = one launch over all 8 levels of "
          "frame 0 with the learned table, its launches from cell I "
          "(rgbd_tum through the CLI); pyramid (K8) = one launch for "
          "levels 1-7 of frame 0, library_ms the plain version's 14 "
          "GEMMs with the weights on the card (bit-equal to K8); "
          "spread_topk (K9) = one launch for the 8 levels' top-k of frame "
          "0, library_ms one stable torch.sort over the padded keys (the "
          "same selection); spread_topk_large (K9's kernel for levels past "
          "8,192 candidates) = one launch for 3840x2160's levels 0-3 of "
          "frame 1, its launches from phase 3k's tracked runs (one a "
          "frame), library_ms the stable sort over those levels' keys; "
          "launches_cell_g / _h / _i / _3k / _3m: those cells' own runs "
          "(_3m: A-pipe, C-pipe, G-pipe and F-pipe together); ba_cg_ut, "
          "ba_cg_ap and ba_cg_update (K6 split at its reductions, the "
          "sharded global BA's CG) = one call of each on cell F's first LM "
          "iteration (CG iteration 0), their launches from phase 3n's "
          "world-size-1 run (dryrun's problem and cell F's first global "
          "BA); wire_unpack (K10) = one launch on a DCT + log8 frame at "
          "the bench's setting (image and depth decoded), its launches "
          "from phase 3p's DCT run (one a buffer), library_ms the plain "
          "version's einsum of the DCT half; *_log8 / *_log8_batch4: the "
          "bench's own buffers (raw image, log8 depth at subsample 8), "
          "one frame and a [4, B] batch; project_search (B6) = the "
          "tracked frame's projection search's gates and compaction "
          "(32,768 points into 8,192 rows), one launch a tracked frame, "
          "library_ms null (no one PyTorch call computes them); "
          "project_features (B6's feature mode) = the tracked frame's "
          "motion-model search's gates (1000 features, the last frame's "
          "map points gathered), one launch a tracked frame, library_ms "
          "null; resolve_claims (R) = the tracked frame's two launches "
          "(the motion-model search's claims in the rows mode, and the "
          "projection search's with the results back per point), "
          "library_ms null (its plain version is the library's "
          "scatter_reduce 'amin', twice)")
    print("phase 3k: " + json.dumps(
        {f"{w}x{h}": {**{k: v for k, v in geo_runs.get((h, w), {}).items()
                         if k != "launches"}, **geo_checks[(h, w)]}
         for h, w in GEOMETRY_CHECKS}))
    print("phase 3j: " + json.dumps(
        {k: {kk: vv for kk, vv in v.items() if kk != "launches"}
         for k, v in drivers_3j.items()}))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
