"""Build, bind and count the port's hand-written CUDA kernels.

Each source in `csrc/` is compiled by `nvcc` into its own shared library
with a plain C interface (`-gencode arch=compute_90a,code=sm_90a`), cached
under `build/torch_kernels/` by a hash of the source and the flags, and
loaded with `ctypes`. Nothing is built when a module is imported: a library
is built the first time a wrapper launches its kernel on a CUDA tensor, or
all at once, in parallel, by `build_all()`.

Every wrapper adds one to `LAUNCHES[name]` where it launches its kernel and
nowhere else, so a run can show that the main path went through it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "torch_kernels")

# name -> (source file, extra nvcc flags)
SOURCES: Dict[str, tuple] = {
    # the window gate compares f32 squared distances: no FMA contraction,
    # so every product and sum rounds exactly as XLA's separate ops do
    "hamming": ("hamming.cu", ["-fmad=false"]),
    "fast": ("fast.cu", []),
    "orb_desc": ("orb_desc.cu", []),
    # every rounding the parity depends on is written out (`__fmul_rn`,
    # `__fadd_rn`), so the default flags keep cosf and sinf torch's own
    "orb_desc_learned": ("orb_desc_learned.cu", []),
    "pose_lm": ("pose_lm.cu", []),
    "ba_assemble": ("ba_assemble.cu", []),
    "ba_schur": ("ba_schur.cu", []),
    # every rounding the plain version's parity depends on is written out
    # (`__fmul_rn`, `__fadd_rn`)
    "ba_schur_sharded": ("ba_schur_sharded.cu", []),
    # `l_x - ur_lvl * sf` must round the product first, as torch does
    "stereo_sad": ("stereo_sad.cu", ["-fmad=false"]),
    # every rounding is written out (`__fmul_rn`, `__fmaf_rn`, `__fadd_rn`),
    # so the default flags change no result of these two
    "pyramid": ("pyramid.cu", []),
    "spread_topk": ("spread_topk.cu", []),
    # K10, the packed frame's decode; `fmaf` is written out
    "wire_unpack": ("wire_unpack.cu", []),
    # B6, the projection and motion-model searches' gates: every product
    # and sum rounds as torch's separate ops do, the fused ones written out
    # (`__fmaf_rn`)
    "project_search": ("project_search.cu", ["-fmad=false"]),
    # R, the claim resolution: integer work only
    "resolve_claims": ("resolve_claims.cu", []),
}

# kernel name -> launches of that kernel since the last reset
LAUNCHES: Dict[str, int] = {"hamming_best2": 0, "fast": 0, "orb_desc": 0,
                            "pose_lm": 0, "ba_point_index": 0,
                            "ba_assemble": 0, "ba_cost": 0,
                            "stereo_sad": 0, "ba_assemble_w_obs": 0,
                            "ba_schur_cg": 0, "orb_desc_learned": 0,
                            "pyramid": 0, "spread_topk": 0,
                            "spread_topk_large": 0, "ba_cg_ut": 0,
                            "ba_cg_ap": 0, "ba_cg_update": 0,
                            "wire_unpack": 0, "project_search": 0,
                            "project_features": 0, "resolve_claims": 0}

# collective name -> calls of the sharded solve's collectives since the last
# reset (`optim/ba.py::collective`), and their host seconds
COLLECTIVES: Dict[str, int] = {"all_reduce": 0, "reduce_scatter": 0,
                               "all_gather": 0}
COLLECTIVE_HOST_S: Dict[str, float] = {k: 0.0 for k in COLLECTIVES}

_BASE_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_count_lock = threading.Lock()


def reset_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0
        COLLECTIVE_HOST_S[k] = 0.0


def counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def count_collective(name: str, host_s: float):
    # ranks may share this process (threads): the two adds under the lock
    with _count_lock:
        COLLECTIVES[name] += 1
        COLLECTIVE_HOST_S[name] += host_s


def collective_counts() -> Dict[str, int]:
    return dict(COLLECTIVES)


def collective_host_s() -> float:
    return sum(COLLECTIVE_HOST_S.values())


def nvcc_path() -> str:
    p = shutil.which("nvcc")
    if p is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        p = "/usr/local/cuda/bin/nvcc"
    if p is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return p


def _lib_path(name: str) -> str:
    src, extra = SOURCES[name]
    h = hashlib.sha256()
    with open(os.path.join(CSRC_DIR, src), "rb") as f:
        h.update(f.read())
    h.update(" ".join(_BASE_FLAGS + extra).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _nvcc_cmd(name: str, out: str) -> List[str]:
    src, extra = SOURCES[name]
    return ([nvcc_path()] + _BASE_FLAGS + extra
            + ["-o", out, os.path.join(CSRC_DIR, src)])


def build_all(names=None) -> Dict[str, str]:
    """Build every missing library, one `nvcc` per source, all started
    together. Returns name -> compiler log (ptxas resource usage)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    names = list(SOURCES) if names is None else list(names)
    procs = {}
    for n in names:
        path = _lib_path(n)
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        procs[n] = (subprocess.Popen(_nvcc_cmd(n, tmp), stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, path)
    failed = []
    for n, (p, tmp, path) in procs.items():
        out, _ = p.communicate()
        with open(path + ".log", "w") as f:
            f.write(out)
        if p.returncode != 0:
            failed.append(f"{n}:\n{out}")
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    logs = {}
    for n in names:
        log = _lib_path(n) + ".log"
        logs[n] = open(log).read() if os.path.exists(log) else ""
    return logs


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of one kernel library, building it if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            path = _lib_path(name)
            if not os.path.exists(path):
                build_all([name])
            _libs[name] = ctypes.CDLL(path)
        return _libs[name]


_bound: Dict[tuple, object] = {}


def bind(name: str, fn: str, argtypes):
    """The C entry `fn` of library `name`, with its argument types set."""
    f = _bound.get((name, fn))
    if f is None:
        f = getattr(load(name), fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        _bound[(name, fn)] = f
    return f


def check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


# levels a multi-level kernel (K2, K3, K7, K8, K9, B9) takes in its by-value
# table
MAX_LEVELS = 16


def ptr_array(ts):
    """A C array of the tensors' data pointers."""
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def int_array(values):
    return (ctypes.c_int * len(values))(*values)


def stream_of(t: torch.Tensor):
    """The current stream of `t`'s device as a C pointer, read through
    torch's raw accessor: `torch.cuda.current_stream()` builds a Stream
    object, 6.0 us of host time a call on the H100's host against 0.7
    (`extract_probe.py`)."""
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(t.device.index))


def require(t: torch.Tensor, what: str, dtype, shape=None):
    """Wrapper-side argument check for a kernel launch."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def require_on(dev: int, specs, what: str):
    """`require`'s checks (device, dtype, shape, contiguity) of a launch's
    tensors in one pass, each spec (name, tensor, dtype, shape or None),
    all on CUDA device `dev`; the failing tensor gets `require`'s message.
    A few attribute reads a tensor, for the wrappers of the per-frame
    launches."""
    for name, t, dtype, shape in specs:
        if (t.get_device() != dev or t.dtype != dtype
                or (shape is not None and t.shape != shape)
                or not t.is_contiguous()):
            require(t, f"{what} {name}", dtype, shape)
            raise ValueError(f"{what} {name}: expected a tensor on cuda:{dev}, "
                             f"got {t.device}")


_tickets: Dict[tuple, torch.Tensor] = {}


def ticket(dev, name: str, n: int) -> torch.Tensor:
    """A cached int32 buffer of at least `n` zeros on `dev` for the kernel
    entry `name`, which leaves it zero after each call (so calls on one
    stream only)."""
    key = (str(dev), name)
    t = _tickets.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros((max(n, 64),), dtype=torch.int32, device=dev)
        _tickets[key] = t
    return t


VP = ctypes.c_void_p
CI = ctypes.c_int
CF = ctypes.c_float
