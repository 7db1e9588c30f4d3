"""PyTorch + CUDA port of the expert-streaming serving stack.

The JAX/Pallas package ``repro`` is the reference; this package mirrors
its layout module for module (``repro_torch.models.moe`` is held against
``repro.models.moe``, and so on) and runs on an NVIDIA Hopper card.  The
one TPU kernel on the serving path, ``streamed_moe``, is a hand-written
CUDA kernel here (``repro_torch.kernels``).

The package imports torch, numpy and the standard library only.  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``; asking
for ``cuda`` where there is none raises (``repro_torch.device``).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
