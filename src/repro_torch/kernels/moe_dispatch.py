"""Capacity dispatch and combine of the MoE block: the CUDA kernels' wrapper.

Replaces no Pallas kernel: the reference moves token rows into the (E, C,
d) capacity buffer and back with XLA's one-hot einsums, O(T·E·C·d) work to
move T·k rows.  ``csrc/moe_dispatch.cu`` moves the rows themselves, from
the tables of ``models.moe.dispatch_tables``; its note says what bounds
the two kernels (bytes) and how they are laid out.

* :func:`gather_dispatch_kernel`: (E, C) token ids -> the (E, C, d) rows in
  the activations' dtype, a zero row for the id T; the one-hot einsum's
  bits.
* :func:`scatter_combine_kernel`: each token's k rows of the fp32 expert
  output times their weights, added from zero in the tables' ascending
  expert order and rounded once to the model dtype: bit for bit
  ``scatter_combine(ye, rows, weights).to(dtype)``, with no atomics, so a
  token's bits never depend on who shares the batch.

For a CUDA tensor each wrapper launches its kernel or raises (bf16 and
fp32 activations only); for a CPU tensor it runs the plain version
(:func:`gather_dispatch`, :func:`scatter_combine`), which repeats the
kernel's arithmetic.  ``LAUNCHES`` counts kernel launches and nothing
else; a call made while a CUDA graph is being captured records the launch
into the graph instead, and ``CAPTURED`` counts those.  The kernels have
no backward: the MoE block takes them only where autograd does not record
(``models.moe``).
"""
from __future__ import annotations

import ctypes

import torch

from .build import launch_on

LAUNCHES = 0
CAPTURED = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def gather_dispatch(x2d, idx):
    """x2d: (T, d); idx: (E, C) -> (E, C, d), zero rows for padding (T)."""
    xpad = torch.cat([x2d, x2d.new_zeros((1, x2d.shape[1]))])
    return xpad.index_select(0, idx.reshape(-1)).view(*idx.shape, -1)


def scatter_combine(ye, rows, weights):
    """ye: (E, C, d) -> (T, d) fp32: the reference's weighted scatter-add,
    computed as a gather.  Token t adds ``ye`` at its k ``rows`` times
    their weights one by one, from zero and in ascending expert order:
    the order in which the reference's scatter over (e, c) reaches them.
    With no atomics the sums are the same bits on every run and whoever
    shares the batch, and only the T·k rows that carry a token are read.
    An overflowed choice (row E*C) adds 0 whatever ``ye`` holds, as the
    reference's drop does."""
    E, C, d = ye.shape
    T, k = rows.shape
    drop = rows == E * C
    g = ye.reshape(E * C, d).index_select(
        0, rows.clamp(max=E * C - 1).reshape(-1)).view(T, k, d)
    g = g.float().masked_fill(drop[..., None], 0.0) * \
        weights.float()[..., None]
    y = torch.zeros((T, d), dtype=torch.float32, device=ye.device)
    for i in range(k):
        y = y + g[:, i]
    return y


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the C launch functions' arguments, the stream last
_ARGTYPES = {"moe_gather_rows_forward": [_P] * 3 + [_L] * 3 + [_P],
             "moe_combine_rows_forward": [_P] * 4 + [_I] * 2 + [_L]
             + [_I] * 2 + [_P]}
_fns = {}


def _kernel_fn(name):
    fn = _fns.get(name)
    if fn is None:
        from .build import load
        fn = getattr(load("moe_dispatch"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _launched(rc, what):
    global LAUNCHES, CAPTURED
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {rc}")
    if torch.cuda.is_current_stream_capturing():
        CAPTURED += 1
    else:
        LAUNCHES += 1


def _on_card(what, dtype, *tensors):
    """Whether the call launches (CUDA) or runs the plain version (CPU);
    raises for another device, mixed devices or a dtype the kernel does
    not take."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: all operands must lie on one device")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {dev}")
    if dtype not in DTYPES:
        raise TypeError(f"{what} kernel takes {list(DTYPES)} activations, "
                        f"got {dtype}")
    return True


def gather_dispatch_kernel(x2d, idx):
    """x2d: (T, d) bf16 | fp32; idx: (E, C) token ids in [0, T], T for an
    empty row -> xe (E, C, d) in x2d's dtype."""
    if x2d.dim() != 2 or idx.dim() != 2:
        raise ValueError(f"want x2d (T, d) and idx (E, C), got "
                         f"{tuple(x2d.shape)} and {tuple(idx.shape)}")
    if not _on_card("gather_dispatch", x2d.dtype, x2d, idx):
        return gather_dispatch(x2d, idx)
    T, d = x2d.shape
    E, C = idx.shape
    x2d = x2d.contiguous()
    idx = idx.to(torch.int64).contiguous()
    xe = torch.empty((E, C, d), dtype=x2d.dtype, device=x2d.device)
    rc = launch_on(x2d.get_device(), _kernel_fn("moe_gather_rows_forward"),
                   (x2d.data_ptr(), idx.data_ptr(), xe.data_ptr(), E * C, T,
                    d * x2d.element_size()))
    _launched(rc, "gather_dispatch")
    return xe


def scatter_combine_kernel(ye, rows, weights, dtype):
    """ye: (E, C, d) fp32 expert rows; rows / weights: (T, k) from
    ``dispatch_tables`` (row E*C: past capacity) -> (T, d) in ``dtype``,
    bit for bit ``scatter_combine(ye, rows, weights).to(dtype)``."""
    if ye.dim() != 3 or rows.dim() != 2 or weights.shape != rows.shape:
        raise ValueError(f"want ye (E, C, d), rows and weights (T, k), got "
                         f"{tuple(ye.shape)}, {tuple(rows.shape)}, "
                         f"{tuple(weights.shape)}")
    if not _on_card("scatter_combine", dtype, ye, rows, weights):
        return scatter_combine(ye, rows, weights).to(dtype)
    if ye.dtype != torch.float32:
        raise TypeError(f"scatter_combine kernel reads fp32 expert rows, got "
                        f"{ye.dtype}")
    E, C, d = ye.shape
    T, k = rows.shape
    ye = ye.contiguous()
    rows = rows.to(torch.int64).contiguous()
    weights = weights.float().contiguous()
    out = torch.empty((T, d), dtype=dtype, device=ye.device)
    rc = launch_on(ye.get_device(), _kernel_fn("moe_combine_rows_forward"),
                   (ye.data_ptr(), rows.data_ptr(), weights.data_ptr(),
                    out.data_ptr(), T, k, E * C, d, DTYPES[dtype]))
    _launched(rc, "scatter_combine")
    return out
