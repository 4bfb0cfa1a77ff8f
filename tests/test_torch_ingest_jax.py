"""The port's fused RGB-D steps against the JAX package's, on the CPU.

The JAX package's `tests/test_batch_ingest.py` scene and configuration
(320x240, 400 features, 4 levels, log8 depth at subsample 2, pipelined at
depth 4). Both packages upload through `prefetch_rgbd` and step in chains
of 4 (`track_rgbd_chain_uploaded`). The JAX tracker's mapper reads are
resolved at once (its `_fetch` returns `_Resolved`), as the port's are on
the CPU, so both run the same schedule. The port's chain is held to JAX's
chain within JAX's own gates for fused steps (`_check(..., tol=0.025,
rel_tol=0.012)`, keyframes +-2).
"""

import numpy as np
import torch

from test_batch_ingest import _cfg
from test_torch_ingest import N, _tracker, frames_gt  # noqa: F401
from orb_slam2_refactored_tpu.io.evaluation import ate_rmse as jax_ate_rmse
from orb_slam2_refactored_tpu.slam.tracking import Tracker as JTracker
from orb_slam2_refactored_tpu.slam.tracking import _Resolved
from orb_slam2_refactored_tpu_torch.io.evaluation import ate_rmse

torch.set_num_threads(1)


def _chain4(t, frames):
    futs = t.prefetch_rgbd([f[0] for f in frames], [f[1] for f in frames])
    for i in range(0, len(frames), 4):
        bufs = [f.result() for f in futs[i:i + 4]]
        t.track_rgbd_chain_uploaded(bufs, [(i + j) / 30.0
                                           for j in range(len(bufs))])
    t.flush()
    return t


def test_chain4_holds_jax_chain4_gates(frames_gt):  # noqa: F811
    frames, gt = frames_gt
    jt = JTracker(_cfg())
    jt.local_mapper._fetch = lambda a: _Resolved(np.asarray(a))
    _chain4(jt, frames)
    j_rmse, _ = jax_ate_rmse(np.stack(jt.trajectory), gt, align="se3")
    t = _chain4(_tracker(), frames)
    est = np.stack(t.trajectory)
    assert est.shape == (N, 7)
    rmse, _ = ate_rmse(est, gt, align="se3")
    print(f"chain-4 ATE port {rmse:.5f} m, JAX {j_rmse:.5f} m; keyframes "
          f"{len(t.graph.alive_kfs())}, JAX {len(jt.graph.alive_kfs())}")
    assert rmse < 0.025, f"ATE {rmse:.4f} m"
    assert abs(rmse - j_rmse) < 0.012, (rmse, j_rmse)
    assert abs(len(t.graph.alive_kfs()) - len(jt.graph.alive_kfs())) <= 2
