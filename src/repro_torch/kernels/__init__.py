"""Hopper kernels of the port and their dispatch layer (``ops``).

One kernel so far: ``streamed_moe`` (CUDA C++, ``csrc/streamed_moe.cu``,
wrapped by the ``streamed_moe`` module), the port of the Pallas
``repro.kernels.streamed_moe`` kernel.  The Pallas flash-attention and
SSD kernels are not ported yet (ROADMAP queue B).
"""
