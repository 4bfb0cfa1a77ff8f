"""PyTorch + CUDA port of the tpu-slam engine (`orb_slam2_refactored_tpu`).

The JAX package beside this one is the reference; every module here mirrors
its counterpart's path (`geometry/`, `ops/`, `optim/`, `solvers/`, `slam/`,
`io/`, `utils/`) so the two are easy to hold against each other. The hot
device stages of the RGB-D and stereo tracking steps run as hand-written
CUDA kernels (`csrc/`, built and bound by `kernels/`); each keeps a plain
PyTorch version next to it that serves CPU tensors.

Conventions shared with the JAX package:
- poses are f32[..., 7] = [qw, qx, qy, qz, tx, ty, tz] (world -> camera);
- descriptors are int32[..., 8], bit-identical to JAX's uint32[..., 8]
  (`.view`), because torch has no popcount and no uint32 shifts on the CPU.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The port runs on `cuda:0` unless the caller asks for another device.

    With no card and no explicit request it raises: nothing falls back to
    the CPU quietly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device; pass device='cpu' to run on the CPU")
        return torch.device("cuda:0")
    return torch.device(device)
