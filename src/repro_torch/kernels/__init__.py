"""Hopper kernels of the port and their dispatch layer (``ops``).

Three CUDA C++ kernels, one for each Pallas kernel of ``repro.kernels``:
``streamed_moe`` (``csrc/streamed_moe.cu``), ``flash_attention``
(``csrc/flash_attention.cu``) and ``ssd`` (``csrc/ssd.cu``, the SSD
intra-chunk terms), each wrapped by the module of the same name, with
its plain PyTorch version and the reference's oracle in ``ref``.
"""
