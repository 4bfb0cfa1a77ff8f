"""Probe extraction's kernels K8 and K7 on one CUDA card: where their
device time goes, and where the host time of the extraction wrappers goes.

    python3 extract_probe.py [--part k8|k7|host|all] [--parent DIR]

1. K8 (`csrc/pyramid.cu`) built from this checkout's source in variants,
   each bound with the kernel's own C signature and launched on the
   bench's VGA frame 0 with the tracker's plan (tap tables, GEMM splits,
   schedule): the kernel as it is; 512 threads a block; tap records read
   from device memory instead of staged in shared memory; and, to split
   its time, the kernel without the tap sums ("floor"), then also without
   its stores to the levels, without the record staging, without level
   0's staging, with none of the three ("bare"), and a launch that returns
   at once ("empty"). Each variant's device time (torch.profiler, in turns:
   every variant, then every variant again in reverse order) and, for the
   variants that compute the pyramid, whether it equals the plain
   pyramid bit for bit.
2. K7 (`csrc/orb_desc_learned.cu`, the learned pattern) built the same way
   and launched through its launch table on frame 0's 1000 keypoints (the
   levels in K8's buffer): the kernel as it is, with its own angles and
   given the plain version's; 256 and 64 threads a keypoint; with
   --parent DIR the first design of the checkout in DIR, bound with its
   own C signature; and, to split its time, without the blur passes or
   one of them, the butterflies, atan2 or the tests, with the window load
   only, and a launch that returns at once. Device times (torch.profiler)
   and CUDA-event times of 50 launches back to back, in turns; the
   variants that compute the function are checked bit for bit against the
   plain version given its angles, and with their own angles against the
   kept kernel.
3. Host time of the extraction wrappers' steps, with CUDA-event time beside
   it (the calls back to back): K8's and K9's wrappers as extraction calls
   them, their parts (plan lookup, output allocation three ways, the C
   call alone, the level views, the stream lookup), K9 on rank rounds it
   must check level by level, K2's wrapper, and K7's wrapper and its
   parts (the table lookup, the level checks, the output allocation, the
   sources, the C call alone; on levels copied apart, a table built on the
   call); with --parent DIR also the K7 wrapper of the checkout in DIR.

Prints one JSON object a part, then the card's name and power limit.
Needs a card and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import timeit

import torch

import chip_smoke
from orb_slam2_refactored_tpu_torch import kernels
from orb_slam2_refactored_tpu_torch.ops import fast, orb
from orb_slam2_refactored_tpu_torch.ops import image as image_ops

OUT_DIR = os.path.join("build", "extract_probe")


def _edit(code, old, new):
    if old not in code:
        raise RuntimeError(f"extract_probe: the source no longer has {old!r}")
    return code.replace(old, new)


def k8_variants():
    """(name, source) of each K8 variant, edited from this checkout's."""
    src = open(os.path.join(kernels.CSRC_DIR, "pyramid.cu")).read()
    stage = "    if (seg % (kThreads / 32) == warp) {"
    img = ("    src[w.i] = __ldg(a.img + (size_t)(sy0 + w.y) * a.w0 + sx0 "
           "+ w.x);")
    store = "        L.dst[(size_t)oy * L.w + ox] = v;"
    glob = _edit(_edit(src, stage, "    if (false) {"),
                 "    const int ny = r.y - r.x, nx = c.y - c.x;\n",
                 "    const int ny = r.y - r.x, nx = c.y - c.x;\n"
                 "    vrec = L.v + kRec * r.x;\n    hrec = L.h + kRec * c.x;\n")
    floor = _edit(src, "  const int4 hd = rec[0];",
                  "  return 0.f;\n  const int4 hd = rec[0];")
    nostore = _edit(floor, store,
                    "        if (v == 12345.f) " + store.strip())
    bare = _edit(_edit(nostore, stage, "    if (false) {"), img,
                 "    src[w.i] = 0.f;")
    return [
        ("kernel", src),
        ("threads_512", _edit(src, "constexpr int kThreads = 1024;",
                              "constexpr int kThreads = 512;")),
        ("records_from_device_memory", glob),
        ("floor", floor), ("floor_no_stores", nostore),
        ("floor_no_record_staging", _edit(floor, stage, "    if (false) {")),
        ("floor_no_level0_staging", _edit(floor, img, "    src[w.i] = 0.f;")),
        ("bare", bare),
        ("empty", _edit(src, "  extern __shared__ int4 s_rec[];",
                        "  extern __shared__ int4 s_rec[];\n"
                        "  if (a.n > 0) return;")),
    ]


def build(variants, stem="pyramid", entry="pyramid_levels",
          argtypes=None):
    """One nvcc a variant, all started together; the bound C entries."""
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for name, code in variants:
        path = os.path.join(OUT_DIR, f"{stem}_{name}.cu")
        with open(path, "w") as f:
            f.write(code)
        so = os.path.join(OUT_DIR, f"lib{stem}_{name}.so")
        procs[name] = (so, subprocess.Popen(
            [kernels.nvcc_path()] + kernels._BASE_FLAGS + ["-o", so, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        print(f"  [{stem} {name}] " + " | ".join(
            ln.strip() for ln in out.splitlines() if "Used" in ln
            or "stack" in ln))
        fn = getattr(ctypes.CDLL(so), entry)
        fn.argtypes = argtypes or ([kernels.CI] + [kernels.VP] * 7
                                   + [kernels.CI] * 5 + [kernels.VP])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def probe_k8(gray):
    plan = image_ops.prepare_pyramid(*gray.shape, 8, 1.2, gray.device)
    ref = image_ops.build_pyramid_plain(gray, 8, 1.2)
    fns = build(k8_variants())
    buf = torch.empty(plan.total, device=gray.device)
    stream = kernels.stream_of(gray)
    levels = [gray] + [buf[o:o + a * b].view(a, b) for o, (a, b) in
                       zip(plan.offsets, plan.shapes[1:])]
    res = {}
    for name, fn in list(fns.items()) + list(fns.items())[::-1]:
        def call(fn=fn):
            kernels.check(fn(8, gray.data_ptr(), buf.data_ptr(), *plan.args,
                             stream), name)
        buf.fill_(float("nan"))
        call()
        torch.cuda.synchronize()
        equal = all(torch.equal(a, b) for a, b in zip(levels, ref))
        ms, _ = chip_smoke.profiled_ms(call, 50)
        res.setdefault(name, {"device_us": []})["device_us"].append(ms * 1e3)
        res[name]["bit_equal"] = equal
    return res


K7_ARGS = orb.LEARNED_ARGS


def k7_variants():
    """(name, source) of each K7 variant, edited from this checkout's."""
    src = open(os.path.join(kernels.CSRC_DIR, "orb_desc_learned.cu")).read()
    rows = "  for (int task = tid; task < kRaw * kRowRuns; task += kThreads) {"
    cols = ("  for (int task = tid; task < kBlur * kColRuns; "
            "task += kThreads) {")
    loaded = "  cp_async_wait_all();\n  __syncthreads();\n"
    start = "  const int k = blockIdx.x;\n"
    tests = ("  for (int v = 0; v < kPerThread; ++v) {\n"
             "    const float ax")
    return [
        ("kernel", src),
        ("threads_256", _edit(src, "constexpr int kThreads = 128;",
                              "constexpr int kThreads = 256;")),
        ("threads_64", _edit(src, "constexpr int kThreads = 128;",
                             "constexpr int kThreads = 64;")),
        ("no_blur", _edit(_edit(src, rows, rows.replace(
            "task < kRaw * kRowRuns", "task < 0")), cols, cols.replace(
                "task < kBlur * kColRuns", "task < 0"))),
        ("no_horizontal", _edit(src, rows, rows.replace(
            "task < kRaw * kRowRuns", "task < 0"))),
        ("no_vertical", _edit(src, cols, cols.replace(
            "task < kBlur * kColRuns", "task < 0"))),
        ("no_butterfly", _edit(src, "for (int off = 16; off > 0; off >>= 1)",
                               "for (int off = 16; off > 16; off >>= 1)")),
        ("no_atan2", _edit(src, "ang = atan2f(b, a);",
                           "ang = __fmul_rn(__fadd_rn(a, b), 1e-9f);")),
        ("no_tests", _edit(src, tests, tests.replace("v < kPerThread",
                                                     "v < 0"))),
        ("load_only", _edit(src, loaded, loaded + "  if (L.n > 0) return;\n")),
        ("empty", _edit(src, start, start + "  if (L.n > 0) return;\n")),
    ]


def parent_k7(parent, lv, ys, xs, ks):
    """A call of the checkout `parent`'s K7 (the first design: its own C
    signature, a by-value table of level pointers built on every call)
    from its own source, writing into (angles, descriptors)."""
    path = os.path.join(parent, "orb_slam2_refactored_tpu_torch", "csrc",
                        "orb_desc_learned.cu")
    fn = build([("first_design", open(path).read())], "orb_desc_learned",
               "orb_learned_levels", [kernels.CI, kernels.VP, kernels.VP,
                                      kernels.VP, kernels.VP, kernels.CI]
               + [kernels.VP] * 8)["first_design"]
    dev = lv[0].device
    tb = orb._tables(dev)
    pat = orb._pattern_table("learned", dev)
    K = ys.shape[0]
    ang = torch.empty((K,), dtype=torch.float32, device=dev)
    desc = torch.empty((K, 8), dtype=torch.int32, device=dev)
    imgs = kernels.ptr_array(lv)
    dims = kernels.int_array([d for x in lv for d in x.shape] + list(ks))

    def call(angles=None):
        kernels.check(fn(len(lv), imgs, dims, ys.data_ptr(), xs.data_ptr(),
                         K, tb["gk"].data_ptr(), tb["xm"].data_ptr(),
                         tb["ym"].data_ptr(), pat.data_ptr(),
                         None if angles is None else angles.data_ptr(),
                         ang.data_ptr(), desc.data_ptr(),
                         kernels.stream_of(lv[0])), "first design")
    return call, ang, desc


def probe_k7(gray, parent=None):
    """Device microseconds of K7's variants on frame 0's keypoints, in
    turns: the kernel with its own angles and given the plain version's;
    256 and 64 threads a keypoint; the first design of the checkout
    `parent`; and
    the kernel's split. Bit-equality where a variant computes the
    function."""
    dev = gray.device
    ks = orb.features_per_level(1000, 8, 1.2)
    plan = orb.prepare_learned(*gray.shape, 1000, 1.2, 8, "learned", dev)
    lv = image_ops.build_pyramid(gray, 8, 1.2)
    ys, xs = chip_smoke.level_keypoints(lv, ks)
    ap, dp = orb.angles_and_descriptors_learned_plain(lv, ys, xs, ks)
    ak, dk = orb.angles_and_descriptors_learned_levels(lv, ys, xs, ks)
    img0, base, table, _ = orb.learned_sources(lv, plan)
    assert table == plan.address
    K = plan.K
    out_ang = torch.empty((K,), dtype=torch.float32, device=dev)
    out_desc = torch.empty((K, 8), dtype=torch.int32, device=dev)
    stream = kernels.stream_of(gray)
    fns = build(k7_variants(), "orb_desc_learned", "orb_learned_levels",
                K7_ARGS)
    runs = {f"{n} (own angles)": (n, None) for n in fns}
    runs["kernel (given angles)"] = ("kernel", ap)
    if parent is not None:
        first, first_ang, first_desc = parent_k7(parent, lv, ys, xs, ks)
        runs["first design, parent's (own angles)"] = ("first", None)
        runs["first design, parent's (given angles)"] = ("first", ap)
    res = {}
    for name, (variant, angles) in (list(runs.items())
                                    + list(runs.items())[::-1]):
        if variant == "first":
            def call(angles=angles):
                first(angles)
            desc, ang = first_desc, first_ang
        else:
            def call(fn=fns[variant], angles=angles):
                kernels.check(fn(img0, base, table, ys.data_ptr(),
                                 xs.data_ptr(), K, None if angles is None
                                 else angles.data_ptr(), out_ang.data_ptr(),
                                 out_desc.data_ptr(), stream), name)
            desc, ang = out_desc, out_ang
        desc.fill_(-1)
        ang.fill_(float("nan"))
        call()
        torch.cuda.synchronize()
        r = res.setdefault(name, {"device_us": [], "cuda_event_us": []})
        try:
            ms, _ = chip_smoke.profiled_ms(call, 50)
            r["device_us"].append(ms * 1e3)
        except RuntimeError as e:  # a window that kept losing a launch
            print(f"  {name}: device time not measured ({e})")
            r["device_us"].append(None)
        r["cuda_event_us"].append(chip_smoke.cuda_time_ms(call, 50) * 1e3)
        if variant in ("kernel", "threads_256", "threads_64", "first"):
            r["bit_equal"] = bool(
                torch.equal(desc, dp) and torch.equal(ang, ap)
                if angles is not None else
                torch.equal(desc, dk) and torch.equal(ang, ak))
    return res


def k7_host_steps(gray, parent=None):
    """Host-time steps of K7's wrapper on frame 0's keypoints."""
    dev = gray.device
    ks = orb.features_per_level(1000, 8, 1.2)
    plan = orb.prepare_learned(*gray.shape, 1000, 1.2, 8, "learned", dev)
    lv = image_ops.build_pyramid(gray, 8, 1.2)
    ys, xs = chip_smoke.level_keypoints(lv, ks)
    apart = [lvl.clone() for lvl in lv]
    K = plan.K
    out_ang = torch.empty((K,), dtype=torch.float32, device=dev)
    out_desc = torch.empty((K, 8), dtype=torch.int32, device=dev)
    img0, base, table, _ = orb.learned_sources(lv, plan)
    fn7 = kernels.bind("orb_desc_learned", "orb_learned_levels", K7_ARGS)
    stream = kernels.stream_of(gray)
    steps = {
        "K7 wrapper (extraction's call, K8's buffer)":
            lambda: orb.angles_and_descriptors_learned_levels(lv, ys, xs, ks),
        "K7 wrapper on levels copied apart (a table built on the call)":
            lambda: orb.angles_and_descriptors_learned_levels(apart, ys, xs,
                                                              ks),
        "K7 table lookup": lambda: orb._learned_plan(
            tuple([tuple(x.shape) for x in lv]), tuple(ks), gray.get_device(),
            orb._pattern_key("learned")),
        "K7 level and keypoint checks": lambda: (
            [kernels.require(x, "l", torch.float32) for x in lv],
            kernels.require(ys, "ys", torch.int32, (K,)),
            kernels.require(xs, "xs", torch.int32, (K,))),
        "K7 outputs (two new_empty: the wrapper's)": lambda: (
            lv[0].new_empty((K,)), ys.new_empty((K, 8))),
        "K7 outputs (one buffer, two views)": lambda: (
            lambda o: (o[:8 * K].view(K, 8), o[8 * K:].view(torch.float32)))(
                torch.empty((9 * K,), dtype=torch.int32, device=dev)),
        "K7 sources (K8's buffer)": lambda: orb.learned_sources(lv, plan),
        "K7 C call alone": lambda: fn7(img0, base, table, ys.data_ptr(),
                                       xs.data_ptr(), K, None,
                                       out_ang.data_ptr(),
                                       out_desc.data_ptr(), stream),
    }
    if parent is not None:
        old = chip_smoke.build_parent(parent)["k7"]
        steps["the parent's K7 wrapper (the first design)"] = (
            lambda: old(lv, ys, xs, ks))
    return steps


def time_steps(steps):
    """Host microseconds a call (`timeit`, 2000 calls) and CUDA-event
    microseconds a call (200 back to back) of each step."""
    res = {}
    for name, fn in steps.items():
        fn()
        torch.cuda.synchronize()
        host = timeit.timeit(fn, number=2000) / 2000 * 1e6
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(200):
            fn()
        end.record()
        torch.cuda.synchronize()
        res[name] = {"host_us": host,
                     "cuda_event_us": start.elapsed_time(end) / 200 * 1e3}
    return res


def one_buffer(K, dev):
    """K9's six outputs as views of one int32 allocation."""
    ys, xs, lv, xy, resp, valid = torch.empty(
        (6 * K + -(-K // 4),), dtype=torch.int32, device=dev).split(
            [K, K, K, 2 * K, K, -(-K // 4)])
    return (ys, xs, xy.view(torch.float32).view(K, 2), lv,
            resp.view(torch.float32), valid.view(torch.bool)[:K])


def host_steps(gray):
    """The steps of K8's, K9's and K2's wrappers."""
    dev = gray.device
    orb.OrbExtractor(*gray.shape, 1000, 1.2, 8, device=dev)
    ks = orb.features_per_level(1000, 8, 1.2)
    lv = image_ops.build_pyramid(gray, 8, 1.2)
    k2 = fast.detect_and_rank(lv, 20.0, 7.0, ks, margin=orb.EDGE_MARGIN)
    ranked = [(r, p) for _, r, p in k2]
    copies = [(r.clone(), p.clone()) for r, p in ranked]
    args = (ranked, ks, [tuple(x.shape) for x in lv], list(range(8)),
            [1.2 ** l for l in range(8)], 32)
    plan = orb._spread_plan(tuple(map(tuple, args[2])), tuple(ks),
                            tuple(args[3]), tuple(map(float, args[4])),
                            tuple([r.shape[0] for r, _ in ranked]), 32)
    out = torch.empty((6 * plan.K + -(-plan.K // 4),), dtype=torch.int32,
                      device=dev)
    fn9 = kernels.bind("spread_topk", "spread_topk_levels",
                       [kernels.CI] + [kernels.VP] * 3 + [kernels.CI] * 4
                       + [kernels.VP, kernels.CI, kernels.VP])
    raw, pos = k2.buffers
    K = plan.K
    outputs = (((K,), torch.int32), ((K,), torch.int32),
               ((K, 2), torch.float32), ((K,), torch.int32),
               ((K,), torch.float32), ((K,), torch.bool))
    pplan = image_ops._pyramid_plan(*gray.shape, 8, 1.2, str(dev))
    buf = torch.empty(pplan.total, device=dev)
    fn8 = kernels.bind("pyramid", "pyramid_levels",
                       [kernels.CI] + [kernels.VP] * 7 + [kernels.CI] * 5
                       + [kernels.VP])
    stream = kernels.stream_of(gray)
    steps = {
        "K8 wrapper (build_pyramid)": lambda: image_ops.build_pyramid(
            gray, 8, 1.2),
        "K8 C call alone": lambda: fn8(8, gray.data_ptr(), buf.data_ptr(),
                                       *pplan.args, stream),
        "K8 level views": lambda: [buf.as_strided((a, b), (b, 1), o) for
                                   o, (a, b) in zip(pplan.offsets,
                                                    pplan.shapes[1:])],
        "K9 wrapper on K2's buffers (extraction's call)":
            lambda: orb.spread_topk_levels(*args, buffers=k2.buffers),
        "K9 wrapper on K2's views, checked level by level":
            lambda: orb.spread_topk_levels(*args),
        "K9 wrapper on copies, packed first":
            lambda: orb.spread_topk_levels(copies, *args[1:]),
        "K9 plan lookup": lambda: orb._spread_plan(
            tuple(map(tuple, args[2])), tuple(ks), tuple(args[3]),
            tuple(map(float, args[4])),
            tuple([r.shape[0] for r, _ in ranked]), 32),
        "K9 outputs (6 torch.empty)": lambda: [
            torch.empty(s, dtype=d, device=dev) for s, d in outputs],
        "K9 outputs (6 new_empty)": lambda: [
            raw.new_empty(s, dtype=d) for s, d in outputs],
        "K9 outputs (one buffer, split, 4 views: the wrapper's)":
            lambda: one_buffer(plan.K, dev),
        "K9 C call alone": lambda: fn9(
            8, raw.data_ptr(), pos.data_ptr(), plan.params, 32, 4,
            orb.EDGE_MARGIN, plan.K, out.data_ptr(), plan.smem, stream),
        "stream lookup (kernels.stream_of)": lambda: kernels.stream_of(gray),
        "torch.cuda.current_stream().cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "K2 wrapper (detect_and_rank)": lambda: fast.detect_and_rank(
            lv, 20.0, 7.0, ks, margin=orb.EDGE_MARGIN),
    }
    return steps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--part", choices=("k8", "k7", "host", "all"),
                    default="all")
    ap.add_argument("--parent", metavar="DIR",
                    help="also time the K7 kernel and wrapper of the "
                    "checkout in DIR")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("extract_probe: no CUDA device", file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build_all(["pyramid", "spread_topk", "fast", "orb_desc_learned"])
    imgs, _, _ = chip_smoke.bench_frames(1)
    gray = image_ops.to_gray(torch.as_tensor(imgs[0], device=dev))
    if args.part in ("k8", "all"):
        print("K8 variants " + json.dumps(probe_k8(gray)))
    if args.part in ("k7", "all"):
        print("K7 variants " + json.dumps(probe_k7(gray, args.parent)))
    if args.part in ("host", "all"):
        steps = {**host_steps(gray), **k7_host_steps(gray, args.parent)}
        print("host steps " + json.dumps(time_steps(steps)))
    print(chip_smoke.card_line())


if __name__ == "__main__":
    main()
