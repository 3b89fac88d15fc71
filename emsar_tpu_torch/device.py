"""Device resolution for the PyTorch port.

``EMSAR_TORCH_DEVICE`` names the device (default ``cuda``), mirroring the
JAX package's ``EMSAR_TPU_PLATFORM`` knob (``emsar_tpu/cli/common.py``).
A missing GPU is an error unless the variable says ``cpu``: a run that was
meant for the card never carries on quietly on the host.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from .utils.timing import note, phase

ENV_VAR = "EMSAR_TORCH_DEVICE"


def resolve_device(name: Optional[str] = None) -> torch.device:
    """The torch device to run on: ``name``, else ``$EMSAR_TORCH_DEVICE``,
    else ``cuda``.  Raises RuntimeError when CUDA is asked for and absent.

    Also pins full-precision float32 matmuls: reduced-precision (TF32)
    products put ~1e-3 relative noise into the EM intensities, above the
    convergence epsilon, and the block-gain loop then spins to max_blocks
    (the same finding as ``emsar_tpu/model/dense.py`` ``_PREC``)."""
    name = name or os.environ.get(ENV_VAR) or "cuda"
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{ENV_VAR}={name!r} but no CUDA device is available; set "
                f"{ENV_VAR}=cpu to run the port on the host")
    elif dev.type != "cpu":
        raise RuntimeError(f"unsupported {ENV_VAR} device {name!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("could not disable TF32 matmuls")
    return dev


def start_up(dev: torch.device, verbose: int = 1) -> None:
    """The phase "device start-up": create ``dev``'s CUDA context (one
    allocation, one synchronise) where the CLI resolved it, so that the
    first step to touch the card does not pay for it.  Nothing to do on
    the CPU."""
    with phase("device start-up", verbose):
        note(device=str(dev))
        if dev.type == "cuda":
            torch.empty(1, device=dev)
            torch.cuda.synchronize(dev)
