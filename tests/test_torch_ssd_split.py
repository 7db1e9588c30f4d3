"""The SSD kernel's split-TF32 arithmetic, emulated in numpy, on the CPU.

The CUDA SSD kernel's long-chunk body (``csrc/ssd.cu``, body 1) takes its
three products (G = C B^T, Y_diag = (G o L) x, state^T = (B o dec)^T x) on
the tensor cores in split TF32: each fp32 operand v is split as hi =
tf32(v), lo = tf32(v - hi) (10 mantissa bits, to nearest), and a product
a b is taken as a_hi b_hi + a_hi b_lo + a_lo b_hi, one TF32 ``wgmma`` per
term, each adding its k8 step's sum into the fp32 accumulator.  The
emulation here models that pessimistically: every k8 step's sum of a term
is exact, and the fp32 accumulator is truncated (toward zero) after each
one.  It lives in this test only; nothing on a path uses it.

Holds, on inputs made from a seed (decays as ``chip_smoke._ssd_inputs``
draws them), at c in {256, 100} and n in {128, 16}, one or two heads:

* the emulation against the JAX oracle (``repro.kernels.ref.
  ssd_intra_chunk_ref``) within 2e-5 and against the port's plain version
  (``kernels.ref.ssd_intra_chunk_plain``) within 1e-5, both as max |error|
  over max |want| (``chip_smoke``'s SSD tolerances);
* one TF32 product (hi b_hi only) missing 1e-5: why the kernel splits.

And the wrapper's switch between the two bodies at ``ssd.SHORT_MAX``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref, ssd

ORACLE_TOL, PLAIN_TOL = 2e-5, 1e-5
CASES = [(256, 128, 1), (256, 16, 2), (100, 128, 1), (100, 16, 2)]
P = 64


def tf32(v):
    """v (fp32) rounded to TF32: 10 mantissa bits, to nearest, ties away
    from zero (the kernel's rounding)."""
    bits = np.ascontiguousarray(v, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _trunc32(x):
    """fp64 -> fp32, rounded toward zero."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _terms(a, split):
    hi = tf32(a)
    if not split:
        return [(hi, None)]
    return [(hi, "hi"), (hi, "lo"), (tf32(a - hi), "hi")]


def emulate(a, b, split=True):
    """a (M, K) @ b (K, N) as the kernel's wgmmas take it: K in k8 steps;
    per term (a_hi b_hi, a_hi b_lo, a_lo b_hi, or a_hi b_hi alone) each
    step's exact sum added into an fp32 accumulator truncated after every
    addition."""
    M, K = a.shape
    pad = -K % 8
    a = np.pad(a, ((0, 0), (0, pad)))
    b = np.pad(b, ((0, pad), (0, 0)))
    b_hi = tf32(b)
    b_part = {"hi": b_hi, "lo": tf32(b - b_hi), None: b_hi}
    acc = np.zeros((M, b.shape[1]), np.float32)
    for ka in range(0, K + pad, 8):
        for a_t, b_t in _terms(a[:, ka:ka + 8], split):
            s = a_t.astype(np.float64) @ b_part[b_t][ka:ka + 8].astype(np.float64)
            acc = _trunc32(acc.astype(np.float64) + s)
    return acc


def emulate_ssd(x, B, C, acum, split=True):
    """One (chunk, head): x (c, p), B and C (c, n), acum (c,) -> Y_diag (c,
    p), state (p, n), the kernel's three products in its order."""
    c = x.shape[0]
    G = emulate(C, B.T, split)
    diff = acum[:, None] - acum[None, :]
    L = np.where(np.tril(np.ones((c, c), bool)), np.exp(diff), 0).astype(np.float32)
    y = emulate((G * L).astype(np.float32), x, split)
    dec = np.exp(acum[-1] - acum).astype(np.float32)
    st = emulate((B * dec[:, None]).astype(np.float32).T, x, split).T
    return y, st


def _inputs(c, n, h, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, 1, c, h, P)).astype(np.float32)
    B = rng.standard_normal((1, 1, c, 1, n)).astype(np.float32)
    C = rng.standard_normal((1, 1, c, 1, n)).astype(np.float32)
    Ac = (-rng.random((1, h, 1, c)) * 0.1).astype(np.float32)
    return x, B, C, Ac, np.cumsum(Ac, -1).astype(np.float32)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _emulated(arrays, split=True):
    x, B, C, _, acum = arrays
    h = x.shape[3]
    outs = [emulate_ssd(x[0, 0, :, i], B[0, 0, :, 0], C[0, 0, :, 0],
                        acum[0, i, 0], split) for i in range(h)]
    y = np.stack([o[0] for o in outs], 1)[None, None]       # (1,1,c,h,p)
    st = np.stack([o[1] for o in outs], 0)[None, None]      # (1,1,h,p,n)
    return y, st


@pytest.fixture(scope="module", params=CASES, ids=[f"c{c}-n{n}-h{h}" for c, n, h in CASES])
def case(request):
    c, n, h = request.param
    arrays = _inputs(c, n, h, seed=c + n)
    x, B, C, Ac, acum = arrays
    Bh, Ch = (np.repeat(a, h, axis=3) for a in (B, C))       # per head
    oracle = [np.asarray(a) for a in jref.ssd_intra_chunk_ref(
        *(jnp.asarray(a) for a in (x, Bh, Ch, Ac, acum)))]
    plain = [a.numpy() for a in ref.ssd_intra_chunk_plain(
        *(torch.from_numpy(a) for a in (x, B, C, acum)))]
    return arrays, oracle, plain


def test_split_meets_the_oracle(case):
    arrays, oracle, _ = case
    for got, want in zip(_emulated(arrays), oracle):
        assert _rel(got, want) <= ORACLE_TOL


def test_split_meets_the_plain_version(case):
    arrays, _, plain = case
    for got, want in zip(_emulated(arrays), plain):
        assert _rel(got, want) <= PLAIN_TOL


def test_one_tf32_product_misses(case):
    arrays, _, plain = case
    errs = [_rel(got, want) for got, want in zip(_emulated(arrays, split=False), plain)]
    assert max(errs) > PLAIN_TOL, errs


def test_tf32_rounds_to_nearest():
    v = np.array([1 + 2 ** -11, 1 + 3 * 2 ** -12, -(1 + 2 ** -10 + 2 ** -11), 3.0],
                 np.float32)
    want = np.array([1 + 2 ** -10, 1 + 2 ** -10, -(1 + 2 ** -9), 3.0], np.float32)
    np.testing.assert_array_equal(tf32(v), want)
    assert not np.any(tf32(np.float32(np.pi)).view(np.uint32) & 0x1FFF)


def test_wrapper_switches_bodies_at_short_max():
    assert ssd.body_for(1) == ssd.body_for(ssd.SHORT_MAX) == 2
    assert ssd.body_for(ssd.SHORT_MAX + 1) == ssd.body_for(256) == 1
    # on the CPU either body's request runs the plain version
    t = [torch.from_numpy(a) for a in _inputs(8, 16, 2)]
    want = ref.ssd_intra_chunk_plain(t[0], t[1], t[2], t[4])
    for body in (None, 1, 2):
        for got, w in zip(ssd.ssd_intra_chunk_kernel(*t, body=body), want):
            torch.testing.assert_close(got, w, rtol=0, atol=0)
