"""Device gate and numeric pinning for the PyTorch/CUDA port.

Replaces `pallas_available` (bayesian_optimization_tpu/ops/pallas_kernels.py)
and `_on_tpu` (bayesian_optimization_tpu/ops/linalg.py): where the JAX
package asked "is this a TPU?" to pick a kernel, the port asks once, at a
public constructor, which device the caller named, and raises when that
device is a GPU that is missing or is not a Hopper part (compute capability
9.0, the target the kernels in csrc/ are built for). Nothing here falls back
to the CPU: the CPU is used only when the caller names it.

Precision is pinned at import. The JAX package runs every likelihood and
posterior matmul at Precision.HIGHEST; float32 matmuls on the card must not
silently drop to TF32, whose ~3 significant digits would look like a bug of
the port.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

DEFAULT_DEVICE = "cuda"

_REQUIRED_CAPABILITY = (9, 0)


def require_cuda() -> None:
    """Raise unless a CUDA device of compute capability 9.0 is present."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "bayesian_optimization_tpu_torch needs an NVIDIA GPU (none found); "
            "pass device='cpu' to run the plain PyTorch path"
        )
    cap = torch.cuda.get_device_capability(0)
    if tuple(cap) != _REQUIRED_CAPABILITY:
        raise RuntimeError(
            f"the port's kernels target compute capability 9.0 (sm_90a); "
            f"device 0 ({torch.cuda.get_device_name(0)}) is {cap[0]}.{cap[1]}"
        )


def resolve_device(device, mesh=None) -> torch.device:
    """torch.device for a public constructor's `device=` argument; a CUDA
    device must pass `require_cuda`. With a particle mesh (parallel/mesh.py)
    the device is the mesh's first device of this process, and `device`
    must name it."""
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; expected 'cuda' or 'cpu'")
    if mesh is not None:
        named = torch.device("cuda", dev.index or 0) if dev.type == "cuda" else dev
        if named != mesh.device:
            raise ValueError(f"device {device!r} is not the mesh's first device {mesh.device}")
        return mesh.device
    return dev
