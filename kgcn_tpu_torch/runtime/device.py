"""Device selection shared by every entry point of the port.

The counterpart of ``kgcn_tpu/runtime/jax_setup.py``: the port runs on the
first CUDA device unless the caller asks for the CPU, and never falls back
from one to the other.  ``set_precision`` maps the config's ``precision``
onto PyTorch's float32 matmul setting, as ``kgcn_tpu``'s ``main()`` maps it
onto ``jax_default_matmul_precision`` (``kgcn_tpu/cli/main.py:702-706``).
"""
from __future__ import annotations

import torch

# TF32 for float32 library matmuls and convolutions: off ("float32" /
# "highest", the default) or on ("default" / "bfloat16")
_TF32 = [False]


def set_precision(precision) -> None:
    """``"float32"`` / ``"highest"``: float32 products in full float32 (TF32
    off), JAX's ``highest``; ``"default"`` and ``"bfloat16"``: TF32 allowed
    for float32 library matmuls and cuDNN convolutions, JAX's ``default``
    matmul precision on a GPU (``"bfloat16"`` also casts each step's payload,
    ``Trainer.compute_dtype``).  Any other value leaves the setting as it
    is, as ``kgcn_tpu`` leaves its own.  The hand-written kernels take no
    TF32 either way."""
    p = str(precision)
    if p in ("float32", "highest"):
        _TF32[0] = False
    elif p in ("default", "bfloat16"):
        _TF32[0] = True
    torch.backends.cuda.matmul.allow_tf32 = _TF32[0]
    torch.backends.cudnn.allow_tf32 = _TF32[0]


def resolve_device(cpu: bool = False) -> torch.device:
    """The current CUDA device (``cuda:0``, or this rank's GPU under
    ``kgcn-torch-launch``, which makes it current), or the CPU when ``cpu``
    is true.  Raises when no CUDA device is visible and the CPU was not
    asked for.

    Float32 library products follow ``set_precision`` (full float32, TF32
    off, unless a config chose ``"default"`` or ``"bfloat16"``), matching
    the JAX suite's ``highest`` matmul precision by default
    (``tests/conftest.py:24``)."""
    torch.backends.cuda.matmul.allow_tf32 = _TF32[0]
    torch.backends.cudnn.allow_tf32 = _TF32[0]
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device visible: kgcn_tpu_torch runs on the GPU unless "
            "the CPU is asked for explicitly (device='cpu' / --cpu)"
        )
    return torch.device("cuda", torch.cuda.current_device())


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
