"""Grouped expert FFN over one d_expert slice: the CUDA kernel's wrapper.

Replaces ``repro/kernels/streamed_moe.py::streamed_moe_kernel`` (Pallas,
TPU).  The kernel (``csrc/streamed_moe.cu``) is bound by the weight
stream at serving shapes and by operations at large C; its note says what
the design does about each.  bf16 activations with bf16 weights run on
Hopper's wgmma fed by TMA (d and m multiples of 8); int8 / fp8 weights
with either activation dtype on wgmma too, transposed: the weights widened
from the raw bytes TMA lands into register A fragments, the activations
the B tiles, the C tile (``q_c_tile``) C rounded up to 16, so decode
computes no padding rows (d and m multiples of 16; fp32 operands split
into three bf16 parts, so the products keep fp32 accuracy; partial sums
promoted into fp32 every 64 k-rows); fp32 weights on wgmma in split TF32
(each fp32 operand two TF32 parts, a product three TF32 terms),
transposed as the 8-bit path, x and h split into planes once (16-byte
rows: d and m multiples of 4; partial sums promoted every 64 k-rows); bf16
weights with fp32 activations take h from CUDA-core fp32 FMAs in the
plain version's order, so its bf16 rounding is the plain version's, and
the down product in split TF32 (d and m multiples of 8).  For a
CUDA tensor the wrapper launches the kernel or raises; for
a CPU tensor it runs the plain version (``kernels.ref.streamed_moe_plain``),
which repeats the kernel's arithmetic.  The tiles are chosen at launch:
``tiles`` names a setting of ``TILE_SETTINGS`` (the tables of
``csrc/streamed_moe.cu``, which every setting gives the same bits as), and
``None`` takes ``DEFAULT_TILES``, the rule the kernel had before it took
settings; ``core.autotune`` plans which.  An unknown setting raises, on
the card and on the CPU alike.  ``LAUNCHES`` counts kernel
launches and nothing else; a call made while a CUDA graph is being
captured records the launch into the graph instead, and ``CAPTURED``
counts those (the graph's owner counts its replays,
``serving.megastep``).
"""
from __future__ import annotations

import ctypes

import torch

from . import ref
from .build import launch_on

LAUNCHES = 0
CAPTURED = 0

ACTIVATIONS = {"swiglu": 0, "relu2": 1, "gelu": 2}
X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
W_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
            torch.float8_e4m3fn: 3}
QUANT_DTYPES = (torch.int8, torch.float8_e4m3fn)

# The kernel's tile settings, path by path, in the order of its tables
# (WG_SETTINGS and Q_SETTINGS in csrc/streamed_moe.cu; a CPU test holds the
# two equal).  bf16 x bf16 (wgmma + TMA): consumer warpgroups (64 rows
# each), columns a block, k-rows a stage, ring depth.  8-bit weights (wgmma
# + TMA, the weights widened into registers): per phase (up, then down)
# consumer warpgroups (64 weight columns each), k-rows a stage, ring depth;
# the C tile follows C (``q_c_tile``).  Split TF32 (fp32 weights, or fp32 x
# x bf16 weights; wgmma + TMA, the weights split into registers): as the
# 8-bit rows, per phase consumer warpgroups, k-rows a stage, ring depth
# (with bf16 weights phase 1 is one CUDA-core tile and only the down
# columns apply).
_WG_ROWS = ((1, 64, 64, 4), (2, 128, 64, 4), (1, 128, 64, 4), (2, 64, 64, 4),
            (1, 64, 64, 2), (1, 128, 64, 2), (2, 64, 64, 3), (2, 128, 64, 3))
_Q_ROWS = (((2, 128, 3), (4, 128, 2)),
           ((2, 128, 3), (2, 128, 2)),
           ((1, 64, 6), (2, 64, 3)),
           ((2, 128, 4), (4, 128, 2)),
           ((2, 64, 6), (4, 64, 4)),
           ((1, 128, 3), (4, 64, 3)))
_T_ROWS = (((2, 64, 2), (4, 64, 2)),
           ((2, 64, 2), (2, 64, 3)))
Q_WG_COLS = 64                      # weight columns a consumer warpgroup owns


def q_c_tile(C: int, x_dtype=torch.bfloat16) -> int:
    """The 8-bit path's C tile (wgmma's N) for C rows: C rounded up to
    16, at most 64; 32 for fp32 x (its three planes share a stage).  The
    split-TF32 path's is C rounded up to 16, at most 64, for any x."""
    if x_dtype == torch.float32:
        return 32
    return min(64, -(-C // 16) * 16)


def _wg_name(warpgroups, bn, bk, stages):
    return f"wg:{warpgroups}x{bn}:k{bk}s{stages}"


def _q_name(up, down, path="8bit"):
    return f"{path}:" + ":".join(
        f"{p}{wg}x{Q_WG_COLS * wg}k{bk}s{st}"
        for p, (wg, bk, st) in (("up", up), ("dn", down)))


TILE_SETTINGS = {
    "bf16": {_wg_name(*row): row for row in _WG_ROWS},
    "8bit": {_q_name(*row): row for row in _Q_ROWS},
    "tf32": {_q_name(*row, path="tf32"): row for row in _T_ROWS},
}


def tile_path(x_dtype, w_dtype) -> str:
    """The kernel path operands of these dtypes take, a key of
    ``TILE_SETTINGS``."""
    if w_dtype in QUANT_DTYPES:
        return "8bit"
    if x_dtype == torch.bfloat16 and w_dtype == torch.bfloat16:
        return "bf16"
    return "tf32"


def DEFAULT_TILES(C: int, w_dtype, x_dtype=torch.bfloat16) -> str:
    """The setting ``tiles=None`` takes: on the bf16 path 64-row blocks
    when C <= 64, else 128; the first row of the other paths."""
    path = tile_path(x_dtype, w_dtype)
    names = list(TILE_SETTINGS[path])
    return names[1] if path == "bf16" and C > 64 else names[0]


def tile_index(tiles, x_dtype, w_dtype, C: int) -> int:
    """The row of its path's table that ``tiles`` names (``None``: the
    default's); raises for a setting the path does not have."""
    path = tile_path(x_dtype, w_dtype)
    if tiles is None:
        tiles = DEFAULT_TILES(C, w_dtype, x_dtype)
    names = list(TILE_SETTINGS[path])
    if tiles not in names:
        raise ValueError(f"unknown streamed_moe tile setting {tiles!r} for "
                         f"the {path} path (x {x_dtype}, weights {w_dtype});"
                         f" known: {names}")
    return names.index(tiles)


_fn = None
_attrs_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        from .build import load
        fn = load("streamed_moe").streamed_moe_forward
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


ATTR_KERNELS = ("up_swiglu", "up_relu2", "up_gelu", "down")
ATTR_FIELDS = ("regs", "spill_bytes", "static_smem", "dynamic_smem",
               "threads")


def tile_attrs(tiles: str, x_dtype, w_dtype, C: int = 64) -> dict:
    """The compiled resources of one setting's kernels on the card, from
    ``cudaFuncGetAttributes``: {kernel: {field: int}} over ``ATTR_KERNELS``
    and ``ATTR_FIELDS`` (registers a thread, local spill bytes a thread,
    shared bytes a block, threads a block).  On the 8-bit path, the kernels
    of C's tile (``q_c_tile``); relu2 and gelu share one kernel there."""
    global _attrs_fn
    if _attrs_fn is None:
        from .build import load
        fn = load("streamed_moe").streamed_moe_tile_attrs
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _attrs_fn = fn
    row = tile_index(tiles, x_dtype, w_dtype, 0)
    out = (ctypes.c_int * (len(ATTR_KERNELS) * len(ATTR_FIELDS)))()
    rc = _attrs_fn(X_DTYPES[x_dtype], W_DTYPES[w_dtype], row, C, out)
    if rc != 0:
        raise RuntimeError(f"streamed_moe_tile_attrs({tiles!r}) failed: "
                           f"cudaError {rc}")
    n = len(ATTR_FIELDS)
    return {k: dict(zip(ATTR_FIELDS, out[i * n:(i + 1) * n]))
            for i, k in enumerate(ATTR_KERNELS)}


def _check(xe, w_g, w_u, w_d, activation, s_g, s_u, s_d):
    """Validate the operands -> (gated, quantized, tensors besides xe).
    Called on every launch, so it compares shapes and devices directly."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    gated = activation == "swiglu"
    if gated and w_g is None:
        raise ValueError("activation='swiglu' requires w_g")
    if xe.ndim != 3 or w_u.ndim != 3 or w_d.ndim != 3:
        raise ValueError("want xe (E,C,d), w_u (E,d,m), w_d (E,m,d)")
    E, C, d = xe.shape
    m = w_u.shape[-1]
    if w_u.shape != (E, d, m) or w_d.shape != (E, m, d):
        raise ValueError(f"shape mismatch: xe {tuple(xe.shape)}, w_u "
                         f"{tuple(w_u.shape)}, w_d {tuple(w_d.shape)}")
    if gated and w_g.shape != w_u.shape:
        raise ValueError(f"w_g {tuple(w_g.shape)} != w_u {tuple(w_u.shape)}")
    if xe.dtype not in X_DTYPES:
        raise TypeError(f"xe dtype {xe.dtype} not in {list(X_DTYPES)}")
    ws = (w_g, w_u, w_d) if gated else (w_u, w_d)
    wdt = w_u.dtype
    if wdt not in W_DTYPES or any(w.dtype != wdt for w in ws):
        raise TypeError(f"weights must share one dtype of {list(W_DTYPES)}, "
                        f"got {[w.dtype for w in ws]}")
    quantized = wdt in QUANT_DTYPES
    tensors = ws
    if quantized:
        scales = ((s_g, (E, 1, m)),) if gated else ()
        scales += ((s_u, (E, 1, m)), (s_d, (E, 1, d)))
        for s, shape in scales:
            if s is None or s.shape != shape or s.dtype != torch.float32:
                raise ValueError(f"quantized {wdt} weights need fp32 "
                                 f"scales {shape}")
        tensors = ws + tuple(s for s, _ in scales)
    elif s_g is not None or s_u is not None or s_d is not None:
        raise ValueError(f"scales given for unquantized {wdt} weights")
    dev = xe.device
    if any(t.device != dev for t in tensors):
        raise ValueError("all operands must lie on one device")
    return gated, quantized, tensors


def row_multiple(x_dtype, w_dtype) -> int:
    """The multiple of d and m (d_expert) the operands' path takes: 8 on
    the bf16 path, 16 on the 8-bit one, and on the split-TF32 path 16
    bytes of a weight row (TMA's row strides): 4 fp32 or 8 bf16."""
    path = tile_path(x_dtype, w_dtype)
    if path == "tf32":
        return 16 // torch.empty((), dtype=w_dtype).element_size()
    return {"bf16": 8, "8bit": 16}[path]


def padded_width(m: int, x_dtype, w_dtype) -> int:
    """m rounded up to its path's multiple (:func:`row_multiple`)."""
    k = row_multiple(x_dtype, w_dtype)
    return -(-m // k) * k


def pad_width(w_g, w_u, w_d, s_g=None, s_u=None, *, m_pad: int):
    """The operands with d_expert zero-padded to ``m_pad``: w_g / w_u
    columns and w_down rows of zeros, 8-bit scale columns of 1 (s_d is
    per output column, d, and stays).  The output does not change: a
    padded h column is act(0) * 0 = 0 for swiglu, relu2 and gelu-tanh,
    and meets a zero row of w_down.  -> (w_g, w_u, w_d, s_g, s_u)."""
    extra = m_pad - w_u.shape[-1]
    if extra <= 0:
        return w_g, w_u, w_d, s_g, s_u

    def cols(t, value=0.0):
        if t is None:
            return None
        return torch.cat([t, t.new_full((*t.shape[:-1], extra), value)], -1)

    w_down = torch.cat([w_d, w_d.new_zeros((w_d.shape[0], extra,
                                            w_d.shape[2]))], 1)
    return cols(w_g), cols(w_u), w_down, cols(s_g, 1.0), cols(s_u, 1.0)


def streamed_moe_kernel(xe, w_g, w_u, w_d, *, activation: str,
                        s_g=None, s_u=None, s_d=None, tiles=None):
    """xe: (E,C,d) fp32|bf16; w_g (swiglu only) / w_u: (E,d,m); w_d:
    (E,m,d), all fp32, bf16, int8 or float8_e4m3fn.  Quantized weights
    take fp32 scales s_g/s_u (E,1,m) and s_d (E,1,d).  ``tiles`` names a
    setting of the operands' path in ``TILE_SETTINGS`` (None: the
    default).  Returns (E,C,d) fp32.  On the card an m the tensor-core
    path does not take is zero-padded to its multiple (:func:`pad_width`);
    the reference's kernel takes any width."""
    checked = _check(xe, w_g, w_u, w_d, activation, s_g, s_u, s_d)
    tile_index(tiles, xe.dtype, w_u.dtype, xe.shape[1])   # raises if unknown
    gated = checked[0]
    if not gated:
        w_g = s_g = None
    if xe.device.type == "cpu":
        return ref.streamed_moe_plain(xe, w_g, w_u, w_d, activation,
                                      s_g=s_g, s_u=s_u, s_d=s_d)
    m_pad = padded_width(w_u.shape[-1], xe.dtype, w_u.dtype)
    if m_pad != w_u.shape[-1]:
        w_g, w_u, w_d, s_g, s_u = pad_width(w_g, w_u, w_d, s_g, s_u,
                                            m_pad=m_pad)
        checked = None
    return _launch(xe, w_g, w_u, w_d, activation, s_g, s_u, s_d, checked,
                   tiles)[1]


def _launch(xe, w_g, w_u, w_d, activation, s_g=None, s_u=None, s_d=None,
            checked=None, tiles=None):
    """Launch the kernel on CUDA tensors -> (h, out): its scratch beside
    the output, so a check can hold h itself.  The scratch is h (E,C,m) in
    bf16 for bf16 x bf16; for int8 / fp8 weights it is flat, h's three
    bf16 planes ``hi + mid + lo`` (3,E,C,m) and then, for fp32 x, x's; for
    fp32 weights flat fp32, h's TF32 planes ``hi + lo`` (2,E,C,m) and then
    fp32 x's lo plane (x is its own hi plane) or bf16 x as fp32; for fp32 x
    x bf16 weights h (E,C,m) in fp32, rounded to bf16.  ``tiles`` names
    the setting (None: the default)."""
    global LAUNCHES, CAPTURED
    gated, quantized, tensors = checked or _check(
        xe, w_g, w_u, w_d, activation, s_g, s_u, s_d)
    row = tile_index(tiles, xe.dtype, w_u.dtype, xe.shape[1])
    if not xe.is_cuda:
        raise ValueError(f"the streamed_moe kernel runs on cuda, not "
                         f"{xe.device}")
    if not xe.is_contiguous() or not all(t.is_contiguous() for t in tensors):
        raise ValueError("streamed_moe kernel needs contiguous operands")
    E, C, d = xe.shape
    m = w_u.shape[-1]
    tensor_cores = xe.dtype == torch.bfloat16 and w_u.dtype == torch.bfloat16
    if tensor_cores and (d % 8 or m % 8 or xe.data_ptr() % 16 or any(
            t.data_ptr() % 16 for t in tensors)):
        raise ValueError(f"the bf16 tensor-core path takes d and m multiples"
                         f" of 8 and 16-byte aligned operands, got d={d}, "
                         f"m={m}")
    if quantized and (d % 16 or m % 16 or xe.data_ptr() % 16 or any(
            t.data_ptr() % 16 for t in tensors)):
        raise ValueError(f"the 8-bit weight path takes d and m multiples of "
                         f"16 and 16-byte aligned operands, got d={d}, m={m}")
    if not (tensor_cores or quantized):
        mult = row_multiple(xe.dtype, w_u.dtype)
        if d % mult or m % mult or xe.data_ptr() % 16 or any(
                t.data_ptr() % 16 for t in tensors):
            raise ValueError(f"the split-TF32 path takes d and m multiples "
                             f"of {mult} and 16-byte aligned operands, got "
                             f"d={d}, m={m}")
    if quantized:    # h as three bf16 planes, then fp32 x's three planes
        h = torch.empty((3 * E * C * (m + (d if xe.dtype == torch.float32
                                            else 0)),),
                        device=xe.device, dtype=torch.bfloat16)
    elif w_u.dtype == torch.bfloat16:
        h = torch.empty((E, C, m), device=xe.device, dtype=xe.dtype)
    else:            # h's TF32 planes, then x's lo plane (or bf16 x as fp32)
        h = torch.empty((E * C * (2 * m + d),), device=xe.device,
                        dtype=torch.float32)
    out = torch.empty((E, C, d), dtype=torch.float32, device=xe.device)
    q = quantized
    args = (xe.data_ptr(), w_g.data_ptr() if gated else None, w_u.data_ptr(),
            w_d.data_ptr(), s_g.data_ptr() if gated and q else None,
            s_u.data_ptr() if q else None, s_d.data_ptr() if q else None,
            h.data_ptr(), out.data_ptr(), E, C, d, m, X_DTYPES[xe.dtype],
            W_DTYPES[w_u.dtype], ACTIVATIONS[activation], row)
    rc = launch_on(xe.get_device(), _kernel_fn(), args)
    if rc != 0:
        raise RuntimeError(f"streamed_moe kernel launch failed: "
                           f"cudaError {rc}")
    if torch.cuda.is_current_stream_capturing():
        CAPTURED += 1
    else:
        LAUNCHES += 1
    return h, out
