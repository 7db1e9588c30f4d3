"""Hopper kernels of the port and their dispatch layer (``ops``).

Three CUDA C++ kernels, one for each Pallas kernel of ``repro.kernels``:
``streamed_moe`` (``csrc/streamed_moe.cu``), ``flash_attention``
(``csrc/flash_attention.cu``) and ``ssd`` (``csrc/ssd.cu``, the SSD
intra-chunk terms), each wrapped by the module of the same name, with
its plain PyTorch version and the reference's oracle in ``ref``
(``flash_ops`` and ``ssd_ops`` are the reference's aliases of ``ops``).
A fourth source, ``csrc/moe_dispatch.cu``, replaces no Pallas kernel: it
moves the MoE block's capacity rows in place of the reference's one-hot
einsums (``moe_dispatch``, its plain versions beside it).
``streamed_moe_autotuned`` runs the grouped FFN with the tile planner's
setting (``core.autotune``).  The dispatch functions named like a kernel
module (``ops.streamed_moe``, ``ops.flash_attention``) stay in ``ops``:
here those names are the modules.
"""
from . import ops, ref  # noqa: F401
from . import ops as flash_ops  # noqa: F401
from . import ops as ssd_ops  # noqa: F401
from .ops import (kernels_enabled, ssd_intra_chunk,  # noqa: F401
                  streamed_moe_autotuned, use_kernels)
