"""PyTorch/CUDA port of the AIDW system (``repro``), for NVIDIA Hopper.

The package mirrors ``repro``'s module names (``core.aidw``, ``core.grid``,
``core.knn``, ``core.pipeline``, ``core.session``, ``kernels.aidw``,
``kernels.knn``) so each counterpart is easy to find.  It imports ``torch``
and numpy only.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no card and no explicit device they raise (:func:`resolve_device`).  The
Pallas kernels of ``repro`` are hand-written CUDA C++ kernels here
(``kernels/*/csrc``), built with ``nvcc`` at first use on a CUDA tensor;
on a CPU tensor each kernel wrapper runs its plain PyTorch twin.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
