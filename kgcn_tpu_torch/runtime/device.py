"""Device selection shared by every entry point of the port.

The counterpart of ``kgcn_tpu/runtime/jax_setup.py``: the port runs on the
first CUDA device unless the caller asks for the CPU, and never falls back
from one to the other.
"""
from __future__ import annotations

import torch


def resolve_device(cpu: bool = False) -> torch.device:
    """``cuda:0``, or the CPU when ``cpu`` is true.  Raises when no CUDA
    device is visible and the CPU was not asked for.

    Float32 products stay in full float32 (TF32 off for matmul and cuDNN),
    matching the JAX suite's ``highest`` matmul precision
    (``tests/conftest.py:24``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device visible: kgcn_tpu_torch runs on the GPU unless "
            "the CPU is asked for explicitly (device='cpu' / --cpu)"
        )
    return torch.device("cuda:0")


def device_from_arg(device) -> torch.device:
    """Map an entry point's ``device`` argument (None, "cpu", "cuda", a
    ``torch.device``) through :func:`resolve_device`."""
    if device is None:
        return resolve_device()
    device = torch.device(device)
    if device.type == "cpu":
        return resolve_device(cpu=True)
    resolve_device()
    return device
