"""DR-SLAM on PyTorch and CUDA: the per-frame RGB-D tracking path of the
JAX package, ported module by module for an NVIDIA Hopper GPU.

Plain tensor code is PyTorch; the projection matcher is a CUDA kernel
(`ops/match_cuda.py`, `csrc/gated_top2_hamming.cu`). Entry points take a
`device` argument and run on `cuda` unless the caller passes
`device="cpu"`; without a GPU they raise instead of falling back.

Geometry runs in true float32: TF32 is turned off for matrix products and
for cuDNN convolutions (the separable image filters), as the JAX reference
pins float32 matmuls."""

import functools

import numpy as np
import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """`None` means the GPU. Raises when a CUDA device is asked for and none
    is present: there is no silent CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev


def to_numpy(x):
    """A tensor (on any device) or an array-like as a numpy array; reading
    a device tensor back waits for it."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@functools.lru_cache(maxsize=256)
def device_const(values: tuple, dtype: torch.dtype = torch.float32,
                 device: torch.device = torch.device("cpu")) -> torch.Tensor:
    """A small constant tensor, copied to `device` once. Building it from
    Python data in per-frame code would copy host -> device, and wait for
    the copy, on every call. Callers must not write into it."""
    return torch.tensor(values, dtype=dtype, device=device)
