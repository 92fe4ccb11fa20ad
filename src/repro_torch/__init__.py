"""PyTorch/CUDA port of the UpDLRM reproduction (the JAX package ``repro``
is the reference it is tested against).

The layout mirrors ``src/repro/``: each module here has the counterpart of
the same name there. The kernels that the JAX package writes in Pallas for
the TPU are hand-written CUDA C++ for Hopper (``kernels/csrc/``), built with
``nvcc`` at first use and bound with ``ctypes``. Every kernel wrapper runs
its plain PyTorch version when given CPU tensors and launches the kernel (or
raises) when given CUDA tensors — there is no silent fallback.

Entry points take an explicit ``device`` that defaults to ``"cuda"``; pass
``device="cpu"`` to run on the host (the tests do). Asking for CUDA on a
host without it raises.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """The device an entry point runs on. ``None`` means ``"cuda"``;
    ``"meta"`` is the dry pass's (shapes only, ``launch/dryrun``), on which
    the kernel wrappers report their cost instead of launching.

    Raises when CUDA is asked for and absent, so a run meant for the card
    never continues on the CPU by accident.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the plain versions on the host")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda, cpu or "
                         f"meta)")
    return dev
