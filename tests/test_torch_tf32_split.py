"""The fp32 bodies of streamed_moe and flash attention, emulated in numpy.

Both CUDA kernels take fp32 products on the tensor cores in split TF32
(``csrc/hopper.cuh``): an fp32 operand v is hi = tf32(v) and lo = tf32(v -
hi) (10 mantissa bits, to nearest), and a product a b is the TF32 wgmmas
a_hi b_hi + a_hi b_lo + a_lo b_hi, each adding its k8 step's sum into an
fp32 accumulator; an operand exact in TF32 (bf16 x, bf16 w_d and h
rounded to bf16) has one part.  The emulation models the tensor cores as
``tests/test_torch_ssd_split.py`` does, pessimistically: each k8 step's
sum of a term is exact, and the accumulator is truncated (toward zero)
after every one.  It lives in this test only.

* ``streamed_moe`` (``csrc/streamed_moe.cu``, the split-TF32 path) with
  fp32 weights: x and h as planes (x is its own hi plane, which the tensor
  cores truncate, and its lo plane the rest rounded), the weights split in
  registers, each T_PROMOTE = 8 k8 steps' partial added, rounded to
  nearest, into the fp32 sum.  At (E, C, d, m) = (4, 37, 256, 96) and down
  products of K = 1024 and 4096.  With bf16 weights and fp32 x only the
  down product is split TF32 (one term: bf16 h, bf16 w_d); h comes from
  fp32 FMAs in the plain version's order on the card, which the CPU's
  plain version does not share, so only the down product is emulated.
* flash attention (``csrc/flash_attention.cu``, ``flash_fwd_tf32``): Q
  split in registers, K and V their own hi planes and their lo planes the
  rest rounded; S = Q K^T per key tile (64 keys at hd 64, 32 at hd 128)
  from zero, the online
  softmax in log2 units, P V per tile from zero, acc = acc * corr + pv.  At
  (B, Sq, Sk, H, hd) = (1, 100, 200, 2, 64) and (1, 64, 64, 2, 128).

Each is held against the JAX oracle (``repro.kernels.ref``: 2e-5 for
streamed_moe with fp32 weights, the reference's 3e-2 with bf16 ones,
which round h; 2e-4 for flash) and the port's plain version (1e-5), as max
|error| over max |want| (``chip_smoke``'s tolerances); a one-TF32-product
variant misses those holds, and the K = 4096 down product summed with no
promotion misses 1e-5: why the kernels split, and why streamed_moe
promotes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref

PLAIN_TOL = 1e-5
MOE_ORACLE_TOL = {"fp32": 2e-5, "bf16": 3e-2}
FLASH_ORACLE_TOL = 2e-4
PROMOTE = 8                       # streamed_moe's T_PROMOTE (k8 steps)


def tf32(v):
    """v (fp32) rounded to TF32: 10 mantissa bits, to nearest, ties away
    from zero (hop::tf32_rna)."""
    bits = np.ascontiguousarray(v, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _trunc32(x):
    """fp64 -> fp32, rounded toward zero."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def trunc_tf32(v):
    """v (fp32) as the tensor cores read it: its top 19 bits."""
    bits = np.ascontiguousarray(v, dtype=np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def parts(v, exact=False, split=True, raw_hi=False):
    """An operand's TF32 parts: [hi, lo], [v] when it is exact in TF32, or
    [tf32(v)] for one TF32 product.  ``raw_hi``: v itself is the hi part
    (the tensor cores truncate it) and lo the rest rounded (hop::tf32_lo),
    as streamed_moe stages fp32 x."""
    if exact:
        return [v.astype(np.float32)]
    hi = trunc_tf32(v) if raw_hi else tf32(v)
    return [hi, tf32(v - hi)] if split else [hi]


def terms(a_parts, b_parts):
    """The kernel's terms, in its order: a_hi b_hi, a_hi b_lo, a_lo b_hi
    (those the parts have)."""
    out = [(0, 0)]
    if len(b_parts) > 1:
        out.append((0, 1))
    if len(a_parts) > 1:
        out.append((1, 0))
    return out


def emulate(a_parts, b_parts, promote=None):
    """sum_k a[..., :, k] b[..., k, :] over K in k8 steps: each step's
    terms add their exact sums into an fp32 partial truncated after each;
    every ``promote`` steps and after the last the partial is added,
    rounded to nearest, into the fp32 sum (``None``: the partial is the
    sum)."""
    K = a_parts[0].shape[-1]
    pad = -K % 8
    a_parts = [np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, pad)]) for a in a_parts]
    b_parts = [np.pad(b, [(0, 0)] * (b.ndim - 2) + [(0, pad), (0, 0)])
               for b in b_parts]
    shape = np.broadcast_shapes(a_parts[0].shape[:-1] + (1,),
                                b_parts[0].shape[:-2] + (1, 1))
    shape = shape[:-1] + (b_parts[0].shape[-1],)
    acc = np.zeros(shape, np.float32)
    part = np.zeros(shape, np.float32)
    steps = (K + pad) // 8
    for ks in range(steps):
        k0 = 8 * ks
        for i, j in terms(a_parts, b_parts):
            s = a_parts[i][..., k0:k0 + 8].astype(np.float64) \
                @ b_parts[j][..., k0:k0 + 8, :].astype(np.float64)
            part = _trunc32(part.astype(np.float64) + s)
        if promote and (ks % promote == promote - 1 or ks == steps - 1):
            acc = acc + part
            part = np.zeros_like(part)
    return acc if promote else part


# ---------------------------------------------------------------- streamed_moe


def _act(kind, u, g=None):
    t = torch.from_numpy(u)
    out = ref._act(kind, t, None if g is None else torch.from_numpy(g))
    return out.numpy()


def emulate_moe(xe, w_g, w_u, w_d, act, split=True, promote=PROMOTE):
    """The split-TF32 streamed_moe body with fp32 weights -> out: x's
    planes (x itself, truncated by the tensor cores, and its rounded lo
    part), the weights split in registers, h as two planes."""
    x = parts(xe, split=split, raw_hi=True)

    def mm(a, w):
        return emulate(a, parts(w, split=split), promote)
    hu = mm(x, w_u)
    h = _act(act, hu, mm(x, w_g) if act == "swiglu" else None)
    return emulate(parts(h, split=split), parts(w_d, split=split), promote)


def _moe_inputs(E, C, d, m, seed):
    rng = np.random.default_rng(seed)
    xe = rng.standard_normal((E, C, d), dtype=np.float32)
    wg, wu = (rng.standard_normal((E, d, m), dtype=np.float32) / np.float32(d ** 0.5)
              for _ in range(2))
    wd = rng.standard_normal((E, m, d), dtype=np.float32) / np.float32(m ** 0.5)
    return xe, wg, wu, wd


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


# (E, C, d, m, activation): the ragged case, and down products of K = m =
# 1024 and 4096
MOE_CASES = [(4, 37, 256, 96, "relu2"), (4, 37, 256, 96, "swiglu"),
             (1, 16, 64, 1024, "swiglu"), (1, 8, 32, 4096, "relu2")]


@pytest.fixture(scope="module", params=MOE_CASES,
                ids=[f"E{c[0]}-C{c[1]}-d{c[2]}-m{c[3]}-{c[4]}" for c in MOE_CASES])
def moe_case(request):
    E, C, d, m, act = request.param
    xe, wg, wu, wd = _moe_inputs(E, C, d, m, seed=m + C)
    if act != "swiglu":
        wg = None
    oracle = np.asarray(jref.streamed_moe_ref(
        jnp.asarray(xe), None if wg is None else jnp.asarray(wg),
        jnp.asarray(wu), jnp.asarray(wd), act))
    t = [None if w is None else torch.from_numpy(w) for w in (wg, wu, wd)]
    plain = ref.streamed_moe_plain(torch.from_numpy(xe), *t, act).numpy()
    return (xe, wg, wu, wd, act), oracle, plain


def test_moe_split_meets_the_oracle(moe_case):
    args, oracle, _ = moe_case
    assert _rel(emulate_moe(*args), oracle) <= MOE_ORACLE_TOL["fp32"]


def test_moe_split_meets_the_plain_version(moe_case):
    args, _, plain = moe_case
    assert _rel(emulate_moe(*args), plain) <= PLAIN_TOL


def test_moe_one_tf32_product_misses(moe_case):
    args, _, plain = moe_case
    err = _rel(emulate_moe(*args, split=False), plain)
    assert err > PLAIN_TOL, err


@pytest.mark.parametrize("act", ["swiglu", "relu2", "gelu"])
def test_moe_bf16_weights_down_product(act):
    """bf16 weights with fp32 x: on the plain version's h (rounded to
    bf16), the down product as one TF32 term a k8 step (h and w_d exact in
    TF32), promoted every 64 k-rows, is within 1e-5 of the plain output and
    3e-2 of the oracle."""
    E, C, d, m = 4, 37, 256, 96
    xe, wg, wu, wd = _moe_inputs(E, C, d, m, seed=m + C)
    wg, wu, wd = (torch.from_numpy(w).to(torch.bfloat16)
                  for w in (wg, wu, wd))
    wg = wg if act == "swiglu" else None
    x = torch.from_numpy(xe)
    h = ref.streamed_moe_plain_h(x, wg, wu, wd, act).numpy()
    got = emulate([h], [wd.float().numpy()], PROMOTE)
    assert _rel(got, ref.streamed_moe_plain(x, wg, wu, wd, act).numpy()) \
        <= PLAIN_TOL
    oracle = np.asarray(jref.streamed_moe_ref(
        jnp.asarray(xe), None if wg is None else jnp.asarray(wg.float().numpy()),
        jnp.asarray(wu.float().numpy()), jnp.asarray(wd.float().numpy()), act))
    assert _rel(got, oracle) <= MOE_ORACLE_TOL["bf16"]


def test_moe_long_down_product_needs_the_promotion():
    """K = 4096 summed on the tensor cores alone (truncating) drifts past
    1e-5; the 64-k-row partials hold it within 1e-6."""
    rng = np.random.default_rng(7)
    h = rng.standard_normal((8, 4096), dtype=np.float32)
    w = rng.standard_normal((4096, 32), dtype=np.float32) / np.float32(64)
    want = (torch.from_numpy(h) @ torch.from_numpy(w)).numpy()
    assert _rel(emulate(parts(h), parts(w), promote=None), want) > PLAIN_TOL
    assert _rel(emulate(parts(h), parts(w), promote=PROMOTE), want) < 1e-6


# ---------------------------------------------------------------------- flash


def emulate_flash(q, k, v, split=True):
    """flash_fwd_tf32 on q (B, Sq, H, hd), k / v (B, Sk, H, hd): per key
    tile (64 keys at hd 64, 32 at hd 128) S from zero in split TF32, the
    online softmax as the kernel's, P V from zero, acc * corr + pv."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    bk = 64 if hd == 64 else 32
    scale = np.float32(ref.flash_scale_log2(hd))
    qh = q.transpose(0, 2, 1, 3)                      # (B, H, Sq, hd)
    kt = k.transpose(0, 2, 3, 1)                      # (B, H, hd, Sk)
    vh = v.transpose(0, 2, 1, 3)                      # (B, H, Sk, hd)
    qp = parts(qh, split=split)                       # split in registers
    m = np.full((B, H, Sq), -1e30, np.float32)
    l = np.zeros((B, H, Sq), np.float32)
    acc = np.zeros((B, H, Sq, hd), np.float32)
    qpos = np.arange(Sq)[:, None] + (Sk - Sq)
    for k0 in range(0, Sk, bk):
        k1 = min(k0 + bk, Sk)
        # K and V are their own hi planes (read truncated), lo the rest
        s = emulate(qp, parts(kt[..., k0:k1], split=split, raw_hi=True))
        s = (s * scale).astype(np.float32)
        kpos = np.arange(k0, k1)[None, :]
        s = np.where(kpos <= qpos, s, np.float32(-1e30))
        m_new = np.maximum(m, s.max(-1))
        p = np.exp2(s - m_new[..., None]).astype(np.float32)
        corr = np.exp2(m - m_new).astype(np.float32)
        l = (l * corr + p.sum(-1, dtype=np.float32)).astype(np.float32)
        pv = emulate(parts(p, split=split),
                     parts(vh[:, :, k0:k1], split=split, raw_hi=True))
        acc = (acc.astype(np.float64) * corr[..., None] + pv).astype(np.float32)
        m = m_new
    out = acc / np.maximum(l, np.float32(1e-30))[..., None]
    return out.transpose(0, 2, 1, 3)


FLASH_CASES = [(1, 100, 200, 2, 64), (1, 64, 64, 2, 128)]


@pytest.fixture(scope="module", params=FLASH_CASES,
                ids=[f"Sq{c[1]}-Sk{c[2]}-hd{c[4]}" for c in FLASH_CASES])
def flash_case(request):
    B, Sq, Sk, H, hd = request.param
    rng = np.random.default_rng(Sq + hd)
    q = rng.standard_normal((B, Sq, H, hd), dtype=np.float32)
    k, v = (rng.standard_normal((B, Sk, H, hd), dtype=np.float32) for _ in range(2))
    oracle = np.asarray(jref.flash_attention_ref(*(jnp.asarray(a) for a in (q, k, v))))
    plain = ref.flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v))).numpy()
    return (q, k, v), oracle, plain


def test_flash_split_meets_the_oracle(flash_case):
    args, oracle, _ = flash_case
    assert _rel(emulate_flash(*args), oracle) <= FLASH_ORACLE_TOL


def test_flash_split_meets_the_plain_version(flash_case):
    args, _, plain = flash_case
    assert _rel(emulate_flash(*args), plain) <= PLAIN_TOL


def test_flash_one_tf32_product_misses(flash_case):
    args, _, plain = flash_case
    err = _rel(emulate_flash(*args, split=False), plain)
    assert err > PLAIN_TOL, err


# ---------------------------------------------------------------- the bounds


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("what,args,fp32,split", [
    ("moe C=64", (32, 64, 1024, 512, "fp32", 4), (0.0962, "operations"),
     (0.0651, "bytes")),
    ("moe C=1280", (32, 1280, 1024, 512, "fp32", 4), (1.923, "operations"),
     (0.781, "operations")),
    ("flash hd 64", (2, 2048, 2048, 16, 64, "fp32", 4), (0.2565, "operations"),
     (0.104, "operations")),
    ("flash hd 128", (2, 2304, 2304, 16, 128, "fp32", 4),
     (0.649, "operations"), (0.264, "operations"))])
def test_split_tf32_bounds(what, args, fp32, split):
    """The bounds ``chip_smoke.py`` prints beside the fp32 bodies: the
    fp32 FMAs' (67 TFLOP/s) and split TF32's (three TF32 products at 495
    TFLOP/s), each the larger of it and the bytes (3.35 TB/s)."""
    cs = _chip_smoke()
    fn = cs.streamed_moe_bound_ms if what.startswith("moe") else cs.flash_bound_ms
    for kw, (ms, by) in (({}, fp32), ({"split": True}, split)):
        got, got_by = fn(*args, **kw)
        assert got == pytest.approx(ms, rel=2e-3) and got_by == by, (kw, got)
    if what.startswith("moe"):  # split TF32 is the fp32 weights' body only
        with pytest.raises(ValueError):
            fn(*args[:4], "bf16", 4, split=True)
