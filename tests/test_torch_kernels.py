"""The port's kernel modules against the JAX package, on the CPU.

* ``repro_torch.kernels.quant.quantize`` gives the reference's q and
  scales bit for bit (int8 and fp8);
* the port's ``streamed_moe`` on CPU tensors (the kernel's plain version)
  matches the Pallas kernel in interpret mode and the reference's
  quantized oracle for every activation and weight format, with an odd
  C; tolerances are the reference's own (``tests/test_quantization.py``
  KERNEL_TOL): 2e-5 for fp32/int8/fp8, 2e-2 for bf16;
* a CPU tensor never touches the kernel's launch counter, and the
  wrapper refuses operands the kernel does not take;
* ``chip_smoke.moe_bf16_check``, which holds the bf16 tensor-core path on
  the card, passes the plain version against itself and fails an h that
  skipped the bf16 rounding or lost part of its contraction;
* with bf16 activations and int8 / fp8 weights (the tensor-core path of
  8-bit weights) the plain version matches the Pallas kernel at 2e-5, at
  the C tiles the kernel takes (16, 48) and a ragged m, and
  the 1e-5 hold of ``chip_smoke.py`` fails the two shortcuts such a
  kernel could take: h rounded to bf16, or x rounded to fp8.

The CUDA kernel itself runs only on the card (``chip_smoke.py``).
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import quant as jquant
from repro.kernels import ref as jref
from repro_torch.kernels import ops, quant, ref
from repro_torch.kernels import streamed_moe as sm

KERNEL_TOL = {"fp32": 2e-5, "int8": 2e-5, "fp8": 2e-5, "bf16": 2e-2}


def _inputs(E=2, C=5, d=16, m=8, seed=0):
    rng = np.random.default_rng(seed)
    xe = rng.standard_normal((E, C, d)).astype(np.float32)
    wg, wu = (rng.standard_normal((E, d, m)).astype(np.float32) * 0.3
              for _ in range(2))
    wd = rng.standard_normal((E, m, d)).astype(np.float32) * 0.3
    return xe, wg, wu, wd


def _q_bits(q: torch.Tensor) -> np.ndarray:
    return q.view(torch.uint8).numpy() if q.dtype == torch.float8_e4m3fn \
        else q.numpy()


@pytest.mark.parametrize("wdt", ["int8", "fp8"])
def test_quantize_bit_identical(wdt):
    _, wg, _, wd = _inputs(E=3, d=40, m=24, seed=1)
    wg[0, :, 3] = 0.0                                  # an all-zero channel
    for w in (wg, wd):
        jq, js = jquant.quantize(jnp.asarray(w), wdt)
        q, s = quant.quantize(torch.from_numpy(w), wdt)
        jq = np.asarray(jq)
        jbits = jq.view(np.uint8) if wdt == "fp8" else jq
        np.testing.assert_array_equal(_q_bits(q), jbits)
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(
            quant.fake_quant(torch.from_numpy(w), wdt).numpy(),
            np.asarray(jquant.fake_quant(jnp.asarray(w), wdt)))


@pytest.mark.parametrize("wdt", ["fp32", "bf16", "int8", "fp8"])
@pytest.mark.parametrize("act", ["swiglu", "relu2", "gelu"])
def test_plain_streamed_moe_matches_pallas_and_oracle(act, wdt):
    xe, wg, wu, wd = _inputs()
    wg = wg if act == "swiglu" else None
    with jops.use_kernels(True):
        pallas = np.asarray(jops.streamed_moe(
            jnp.asarray(xe), None if wg is None else jnp.asarray(wg),
            jnp.asarray(wu), jnp.asarray(wd), act, weight_dtype=wdt,
            interpret=True))
    oracle = np.asarray(jref.streamed_moe_quant_ref(
        jnp.asarray(xe), None if wg is None else jnp.asarray(wg),
        jnp.asarray(wu), jnp.asarray(wd), act, wdt))
    t = [None if a is None else torch.from_numpy(a) for a in (xe, wg, wu, wd)]
    before = sm.LAUNCHES
    got = ops.streamed_moe(*t, act, weight_dtype=wdt)
    assert sm.LAUNCHES == before            # CPU tensors: plain version only
    assert got.dtype == torch.float32 and tuple(got.shape) == xe.shape
    tol = KERNEL_TOL[wdt]
    np.testing.assert_allclose(got.numpy(), pallas, rtol=tol, atol=tol)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=tol, atol=tol)
    # the port's own oracle is the reference's oracle
    mine = ref.streamed_moe_quant_ref(*t, act, wdt)
    np.testing.assert_allclose(mine.numpy(), oracle, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_oracle_path_matches_reference_bf16_activations(act):
    """``use_kernels(False)`` with bf16 activations and weights runs the
    reference's einsum oracle in bf16 (rounding differs by framework)."""
    xe, wg, wu, wd = _inputs(C=7)
    j = [jnp.asarray(a, jnp.bfloat16) for a in (xe, wg, wu, wd)]
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in (xe, wg, wu, wd)]
    want = np.asarray(jref.streamed_moe_ref(*j, act))
    with ops.use_kernels(False):
        got = ops.streamed_moe(*t, act)
    np.testing.assert_allclose(got.numpy(), want, rtol=4e-2, atol=4e-2)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    xe, wg, wu, wd = (torch.from_numpy(a) for a in _inputs())
    with pytest.raises(ValueError):
        sm.streamed_moe_kernel(xe, None, wu, wd, activation="swiglu")
    with pytest.raises(ValueError):
        sm.streamed_moe_kernel(xe, wg, wu, wd, activation="silu")
    with pytest.raises(ValueError):
        sm.streamed_moe_kernel(xe, wg, wu, wd.transpose(1, 2),
                               activation="swiglu")
    with pytest.raises(TypeError):
        sm.streamed_moe_kernel(xe.double(), wg, wu, wd, activation="swiglu")
    with pytest.raises(TypeError):
        sm.streamed_moe_kernel(xe, wg, wu.bfloat16(), wd, activation="swiglu")
    q, s = quant.quantize(wu, "int8")
    with pytest.raises(ValueError):                    # scales missing
        sm.streamed_moe_kernel(xe, None, q, quant.quantize(wd, "int8")[0],
                               activation="relu2", s_u=s)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("fault", [None, "unrounded_h", "short_contraction"])
@pytest.mark.parametrize("act", ["swiglu", "relu2", "gelu"])
@pytest.mark.parametrize("d", [64, 1024])   # toy width; granite's d_model
def test_moe_bf16_check_has_teeth(act, fault, d):
    xe, wg, wu, wd = (torch.from_numpy(a).to(torch.bfloat16)
                      for a in _inputs(E=2, C=37, d=d, m=48, seed=2))
    wg = wg if act == "swiglu" else None
    h_plain = ref.streamed_moe_plain_h(xe, wg, wu, wd, act)
    h = h_plain
    if fault == "unrounded_h":               # a kernel that skips the rounding
        h = ref.streamed_moe_plain_h(xe, wg, wu, wd.float(), act)
    elif fault == "short_contraction":       # one that drops the last k16 step
        x = xe.clone()
        x[..., -16:] = 0
        h = ref.streamed_moe_plain_h(x, wg, wu, wd, act)
    out = torch.einsum("ecm,emd->ecd", h, wd.float())
    ok, metrics = _chip_smoke().moe_bf16_check(h, out, h_plain, xe, wg, wu,
                                               wd, act)
    assert ok == (fault is None), metrics


@pytest.mark.parametrize("wdt", ["int8", "fp8"])
@pytest.mark.parametrize("act", ["swiglu", "relu2", "gelu"])
@pytest.mark.parametrize("C,m", [(7, 8), (16, 8), (48, 8), (16, 96),
                                 (48, 96)])
def test_plain_bf16_activations_8bit_weights_match_pallas(act, wdt, C, m):
    """bf16 x with int8 / fp8 weights (the fp8 serving path): the plain
    version (the kernel's arithmetic: the stored values multiplied, the
    scale applied to the fp32 sum, h kept in fp32) against the Pallas kernel
    in interpret mode on the same bf16 x, at the reference's 2e-5.  C = 16
    and 48 are C tiles the 8-bit kernel takes whole (the decode steps of
    Yuan2 / Phi-3.5 / Jamba and of DeepSeek), C = 7 one it pads; m = 96 a
    ragged width (the ring's 88, padded)."""
    xe, wg, wu, wd = _inputs(C=C, m=m)
    wg = wg if act == "swiglu" else None
    xb = torch.from_numpy(xe).to(torch.bfloat16)
    with jops.use_kernels(True):
        pallas = np.asarray(jops.streamed_moe(
            jnp.asarray(xb.float().numpy(), jnp.bfloat16),
            None if wg is None else jnp.asarray(wg), jnp.asarray(wu),
            jnp.asarray(wd), act, weight_dtype=wdt, interpret=True))
    t = [None if a is None else torch.from_numpy(a) for a in (wg, wu, wd)]
    got = ops.streamed_moe(xb, *t, act, weight_dtype=wdt)
    assert got.dtype == torch.float32
    tol = KERNEL_TOL[wdt]
    np.testing.assert_allclose(got.numpy(), pallas.astype(np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("shortcut", ["h_bf16", "x_fp8"])
@pytest.mark.parametrize("wdt", ["int8", "fp8"])
@pytest.mark.parametrize("d", [64, 1024])   # toy width; granite's d_model
def test_plain_hold_fails_8bit_shortcuts(d, wdt, shortcut):
    """``chip_smoke.py`` holds the int8 / fp8 kernel to its plain version at
    PLAIN_TOL (1e-5).  A kernel that rounded h to bf16 before the down
    product, or x to fp8 to use fp8 mma, would miss it by far: on these
    inputs (swiglu, bf16 x, E=2, C=37, m=48) the first moves the output by
    1.3e-3 to 2.6e-3 of max |out| and the second by 2.7e-2 to 4.7e-2, both
    over 100x the tolerance, which is what the test asserts."""
    xe, wg, wu, wd = (torch.from_numpy(a) for a in _inputs(E=2, C=37, d=d,
                                                           m=48, seed=3))
    x = xe.to(torch.bfloat16)
    ws, scales = _chip_smoke()._stream_operands(wg, wu, wd, wdt)
    plain = ref.streamed_moe_plain(x, *ws, "swiglu", **scales)
    if shortcut == "h_bf16":
        h = ref.streamed_moe_plain_h(x, *ws, "swiglu", s_g=scales["s_g"],
                                     s_u=scales["s_u"])
        got = torch.einsum("ecm,emd->ecd", h.to(torch.bfloat16).float(),
                           ws[2].float()) * scales["s_d"]
    else:
        x8 = x.float().to(torch.float8_e4m3fn).float()
        got = ref.streamed_moe_plain(x8, *ws, "swiglu", **scales)
    rel = ((got - plain).abs().max() / plain.abs().max()).item()
    assert rel > 100 * _chip_smoke().PLAIN_TOL, rel


# ---------------------------------------------------------------------------
# d_expert widths the tensor-core paths do not take: the ring's per-rank
# micro-slices (granite at P = 8 with 16 micro-slices: m = 4; DeepSeek at
# P = 8 with 2: m = 88, not a multiple of 16).  On the card the wrapper
# zero-pads m (sm.pad_width); here the padded operands go through the
# plain version and must give the unpadded output bit for bit.  The CPU
# GEMMs sum in an order that depends on the matrix shapes, so the inputs
# are chosen to make every sum exact in any order: small integers for x,
# weights on a grid of 2^-3 (whose int8 / fp8 codes are exact too, the
# scales applied after an exact sum), and a w_down with one non-zero per
# output column (one product a sum, padded terms zero).  C = 16 makes
# every h tensor a whole number of 64-element blocks, so each element's
# activation takes the CPU's vectorized loop in both layouts (its scalar
# tail rounds silu and gelu-tanh differently).
# ---------------------------------------------------------------------------


def _exact_moe_case(m, act, wdt, x_dtype, E=3, C=16, d=32):
    g = torch.Generator().manual_seed(m)
    xe = torch.randint(-4, 5, (E, C, d), generator=g).float().to(x_dtype)
    w_up = [torch.randint(-3, 4, (E, d, m), generator=g).float() / 8
            for _ in range(2)]
    wd = torch.zeros(E, m, d)
    rows = torch.randint(0, m, (E, d), generator=g)
    wd.scatter_(1, rows[:, None, :], torch.randint(
        1, 4, (E, 1, d), generator=g).float() / 8)
    ws = [w_up[0] if act == "swiglu" else None, w_up[1], wd]
    if wdt in quant.QUANTIZED:
        (wg, sg), (wu, su), (wd, sd) = [
            quant.quantize(w, wdt) if w is not None else (None, None)
            for w in ws]
        return xe, (wg, wu, wd), dict(s_g=sg, s_u=su, s_d=sd)
    return xe, tuple(quant.storage_cast(w, wdt) for w in ws), {}


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wdt", ["fp32", "bf16", "int8", "fp8"])
@pytest.mark.parametrize("act", ["swiglu", "relu2", "gelu"])
@pytest.mark.parametrize("m", [4, 12, 88])
def test_padded_width_gives_the_same_bits(m, act, wdt, x_dtype):
    xe, (wg, wu, wd), sc = _exact_moe_case(m, act, wdt, x_dtype)
    want = ref.streamed_moe_plain(xe, wg, wu, wd, act, **sc)
    h = ref.streamed_moe_plain_h(xe, wg, wu, wd, act, s_g=sc.get("s_g"),
                                 s_u=sc.get("s_u"))
    m_pad = sm.padded_width(m, x_dtype, wu.dtype)
    assert m_pad % sm.row_multiple(x_dtype, wu.dtype) == 0
    m_pad = max(m_pad, m + 8)           # pad on every path here
    pg, pu, pd, psg, psu = sm.pad_width(wg, wu, wd, sc.get("s_g"),
                                        sc.get("s_u"), m_pad=m_pad)
    assert pu.shape[-1] == pd.shape[1] == m_pad
    assert not pd[:, m:].any() and not pu[..., m:].float().any()
    hp = ref.streamed_moe_plain_h(xe, pg, pu, pd, act, s_g=psg, s_u=psu)
    assert torch.equal(hp[..., :m], h) and not hp[..., m:].any()
    got = ref.streamed_moe_plain(xe, pg, pu, pd, act, s_g=psg, s_u=psu,
                                 s_d=sc.get("s_d"))
    assert torch.equal(got, want)
    assert torch.equal(sm.streamed_moe_kernel(xe, wg, wu, wd, activation=act,
                                              **sc), want)


def test_padded_widths_of_the_ring():
    bf, f32 = torch.bfloat16, torch.float32
    assert [sm.padded_width(m, bf, bf) for m in (4, 8, 16, 32, 64, 88)] == \
        [8, 8, 16, 32, 64, 88]
    assert [sm.padded_width(m, bf, torch.int8) for m in (4, 8, 88)] == \
        [16, 16, 96]
    assert sm.padded_width(4, f32, torch.float8_e4m3fn) == 16
    # split TF32: 16-byte weight rows, 4 fp32 or 8 bf16
    assert [sm.padded_width(m, f32, f32) for m in (4, 8, 10, 88)] == \
        [4, 8, 12, 88]
    assert sm.padded_width(4, bf, f32) == 4
    assert [sm.padded_width(m, f32, bf) for m in (4, 12, 88)] == [8, 16, 88]
    w = torch.ones(2, 8, 4)
    assert sm.pad_width(None, w, w.transpose(1, 2), m_pad=4)[1] is w
