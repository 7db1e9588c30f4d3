"""Model code of the port: the decoder-only LM with MoE FFNs, Mamba-2 and
Whisper, behind the entry points of ``api``."""
from . import (api, attention, layers, mamba2, mlp, moe,  # noqa: F401
               transformer, whisper)
from .api import (decode_fn, init_decode_caches, init_params,  # noqa: F401
                  loss_fn, prefill_fn)
