"""Probe extraction's kernels K8 and K9 on one CUDA card: where K8's device
time goes, and where the host time of the extraction wrappers goes.

    python3 extract_probe.py

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
2. Host time of the extraction wrappers' steps, with CUDA-event time beside
   it (the calls back to back): K8's and K9's wrappers as extraction calls
   them, their parts (plan lookup, output allocation three ways, the C
   call alone, the level views, the stream lookup), K9 on rank rounds it
   must check level by level, and K2's wrapper.

Prints one JSON object a part, then the card's name and power limit.
Needs a card and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

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


def build(variants):
    """One nvcc a variant, all started together; the bound C entries."""
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for name, code in variants:
        path = os.path.join(OUT_DIR, f"pyramid_{name}.cu")
        with open(path, "w") as f:
            f.write(code)
        so = os.path.join(OUT_DIR, f"libpyramid_{name}.so")
        procs[name] = (so, subprocess.Popen(
            [kernels.nvcc_path()] + kernels._BASE_FLAGS + ["-o", so, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        fn = ctypes.CDLL(so).pyramid_levels
        fn.argtypes = ([kernels.CI] + [kernels.VP] * 7 + [kernels.CI] * 5
                       + [kernels.VP])
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


def one_buffer(K, dev):
    """K9's six outputs as views of one int32 allocation."""
    ys, xs, lv, xy, resp, valid = torch.empty(
        (6 * K + -(-K // 4),), dtype=torch.int32, device=dev).split(
            [K, K, K, 2 * K, K, -(-K // 4)])
    return (ys, xs, xy.view(torch.float32).view(K, 2), lv,
            resp.view(torch.float32), valid.view(torch.bool)[:K])


def probe_host(gray):
    """Host microseconds a call (`timeit`, 2000 calls) and CUDA-event
    microseconds a call (200 back to back) of the wrappers' steps."""
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


def main():
    if not torch.cuda.is_available():
        print("extract_probe: no CUDA device", file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build_all(["pyramid", "spread_topk", "fast"])
    imgs, _, _ = chip_smoke.bench_frames(1)
    gray = image_ops.to_gray(torch.as_tensor(imgs[0], device=dev))
    print("K8 variants " + json.dumps(probe_k8(gray)))
    print("host steps " + json.dumps(probe_host(gray)))
    print(chip_smoke.card_line())


if __name__ == "__main__":
    main()
