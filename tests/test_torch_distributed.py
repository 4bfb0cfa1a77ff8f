"""Multi-process sharded BA on the port: two OS processes over gloo on the
CPU, `parallel/distributed.py::initialize` and `run_multiprocess_ba`, the
counterpart of `tests/test_distributed.py`; and the port's copy of
`__graft_entry__.make_ba_problem` against JAX's."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from __graft_entry__ import make_ba_problem as jax_make_ba_problem
from orb_slam2_refactored_tpu_torch.parallel import distributed

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[4])
from orb_slam2_refactored_tpu_torch.parallel.distributed import (
    initialize, run_multiprocess_ba)
pid, nproc, coord = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dev = initialize(coord, nproc, pid, backend="gloo", device="cpu")
try:
    assert dev.type == "cpu", dev
    c0, c1 = run_multiprocess_ba(K=64, N=128, P=2048, device="cpu")
    print(f"RESULT {pid} {c0.hex()} {c1.hex()}", flush=True)
    dist.barrier()
finally:
    # gloo's threads abort the process at exit while its group lives
    dist.destroy_process_group()
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_sharded_ba(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    coord = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(pid), "2", coord, ROOT],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=ROOT)
        for pid in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        outs.append(out.decode())
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
    results = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("RESULT"):
                _, pid, c0, c1 = line.split()
                results[int(pid)] = (float.fromhex(c0), float.fromhex(c1))
    assert set(results) == {0, 1}, outs
    # the costs are all-reduced: both processes hold the same bits
    assert results[0] == results[1]
    c0, c1 = results[0]
    assert np.isfinite(c1) and c1 < c0


def test_make_ba_problem_equals_jax():
    """Every array within 1e-6 of its largest magnitude: the poses and
    points agree to f32 rounding, and the projections (~100 px) to a few
    of its ulps, where XLA fuses the rotation's products."""
    jp, jc = jax_make_ba_problem(K=64, N=128, P=2048)
    tp, tc = distributed.make_ba_problem(K=64, N=128, P=2048)
    assert tuple(tc) == tuple(float(v) for v in jc)
    for name in jp._fields:
        j = getattr(jp, name)
        if j is None:
            assert getattr(tp, name) is None
            continue
        t = getattr(tp, name).numpy()
        j = np.asarray(j)
        assert t.dtype == j.dtype and t.shape == j.shape, name
        scale = max(float(np.abs(j.astype(np.float64)).max()), 1.0)
        gap = float(np.abs(t.astype(np.float64) - j.astype(np.float64)).max())
        assert gap <= 1e-6 * scale, (name, gap, scale)


def test_initialize_takes_nccl_and_refuses_a_missing_card(monkeypatch):
    """backend None means NCCL, which needs a card: without one it raises
    before any rendezvous instead of falling back to gloo."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="gloo"):
        distributed.initialize("127.0.0.1:1", 1, 0)


@pytest.mark.parametrize("entry", ["initialize_gloo", "run_multiprocess_ba",
                                   "dryrun"])
def test_entries_refuse_a_missing_card(monkeypatch, entry):
    """No entry takes the CPU unless the caller passes device="cpu": without
    a card, gloo's `initialize`, `run_multiprocess_ba` and `dryrun` raise
    as `resolve_device` does, before any rendezvous or solve."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {"initialize_gloo": lambda: distributed.initialize(
                "127.0.0.1:1", 1, 0, backend="gloo"),
            "run_multiprocess_ba": distributed.run_multiprocess_ba,
            "dryrun": distributed.dryrun}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
