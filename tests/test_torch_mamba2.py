"""The port's Mamba-2 block and SSD kernel against the JAX package, CPU.

* ``kernels.ref.ssd_intra_chunk_plain`` (what the wrapper runs for CPU
  tensors: the CUDA kernel's arithmetic) matches the Pallas kernel in
  interpret mode and the reference's oracle at the reference's shapes
  (``tests/test_kernels.py``) plus an odd chunk, at the reference's 2e-5,
  and with B and C per group (g in {1, 2, h}) against the Pallas kernel on
  the operands broadcast to every head;
* ``ssd_chunked`` with ``use_kernel`` on and off matches the JAX one,
  the 16-chunk loop included, and the port's sequential ``ssd_naive``,
  within 2e-4 (the reference's chunked-vs-naive tolerance: the chunked
  and sequential sums run in other orders), at one group and at two;
* ``mamba2_block`` on reduced mamba2-370m, with the JAX weights bridged
  leaf for leaf, matches the JAX block in fp32 within 1e-4 (kernel and
  plain paths), and the configs match the reference's.

The CUDA kernel itself runs only on the card (``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduced_config as jreduced
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ssd import ssd_intra_chunk_kernel as jssd
from repro.models import mamba2 as jm2
from repro.models import transformer as jtf
from repro_torch import bridge
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd
from repro_torch.models import mamba2, transformer

ARCH = "mamba2-370m"
KERNEL_TOL = 2e-5
CHUNKED_TOL = 2e-4
BLOCK_TOL = 1e-4


def _ssd_inputs(b, nc, c, h, p, n, seed):
    rng = np.random.default_rng(seed)
    xc = rng.standard_normal((b, nc, c, h, p)).astype(np.float32)
    Bc = rng.standard_normal((b, nc, c, h, n)).astype(np.float32)
    Cc = rng.standard_normal((b, nc, c, h, n)).astype(np.float32)
    Ac = (-np.abs(rng.standard_normal((b, h, nc, c))) * 0.1).astype(np.float32)
    return xc, Bc, Cc, Ac, np.cumsum(Ac, -1).astype(np.float32)


@pytest.mark.parametrize("b,nc,c,h,p,n", [(1, 2, 16, 2, 8, 4), (2, 3, 32, 4, 16, 8),
                                          (1, 1, 8, 1, 4, 4), (1, 2, 100, 3, 8, 4)])
def test_plain_matches_pallas_and_oracle(b, nc, c, h, p, n):
    arrays = _ssd_inputs(b, nc, c, h, p, n, seed=b * 10 + nc)
    pallas = [np.asarray(a) for a in jssd(*(jnp.asarray(a) for a in arrays))]
    oracle = [np.asarray(a) for a in jref.ssd_intra_chunk_ref(
        *(jnp.asarray(a) for a in arrays))]
    t = [torch.from_numpy(a) for a in arrays]
    before = ssd.LAUNCHES
    got = ssd.ssd_intra_chunk_kernel(*t)
    assert ssd.LAUNCHES == before           # CPU tensors: plain version only
    mine = ref.ssd_intra_chunk_ref(*t)
    for g, p_, o, m in zip(got, pallas, oracle, mine):
        assert g.dtype == torch.float32 and tuple(g.shape) == o.shape
        np.testing.assert_allclose(g.numpy(), p_, rtol=KERNEL_TOL, atol=KERNEL_TOL)
        np.testing.assert_allclose(g.numpy(), o, rtol=KERNEL_TOL, atol=KERNEL_TOL)
        np.testing.assert_allclose(m.numpy(), o, rtol=KERNEL_TOL, atol=KERNEL_TOL)


def _scan_inputs(b, l, h, p, n, seed, g=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    A = (-np.abs(rng.standard_normal(h))).astype(np.float32)
    Bm = rng.standard_normal((b, l, g, n)).astype(np.float32)
    Cm = rng.standard_normal((b, l, g, n)).astype(np.float32)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("b,nc,c,p,n", [(1, 2, 16, 8, 4), (2, 1, 100, 8, 4)])
def test_plain_per_group_matches_pallas_on_broadcast(b, nc, c, p, n, g):
    """B and C per group, as ``ssd_chunked(use_kernel=True)`` passes them:
    the plain version and the oracle against the Pallas kernel (which takes
    them per head) on the operands repeated to the h = 4 heads."""
    h = 4
    xc, _, _, Ac, Acum = _ssd_inputs(b, nc, c, h, p, n, seed=c + g)
    rng = np.random.default_rng(g)
    Bg, Cg = (rng.standard_normal((b, nc, c, g, n)).astype(np.float32)
              for _ in range(2))
    Bh, Ch = (np.repeat(a, h // g, axis=3) for a in (Bg, Cg))
    pallas = [np.asarray(a) for a in jssd(*(jnp.asarray(a) for a in
                                            (xc, Bh, Ch, Ac, Acum)))]
    t = [torch.from_numpy(a) for a in (xc, Bg, Cg, Ac, Acum)]
    got = ssd.ssd_intra_chunk_kernel(*t)
    mine = ref.ssd_intra_chunk_ref(*t)
    for gt, m, p_ in zip(got, mine, pallas):
        assert tuple(gt.shape) == p_.shape
        np.testing.assert_allclose(gt.numpy(), p_, rtol=KERNEL_TOL, atol=KERNEL_TOL)
        np.testing.assert_allclose(m.numpy(), p_, rtol=KERNEL_TOL, atol=KERNEL_TOL)


@pytest.mark.parametrize("chunk,l", [(16, 64), (8, 128), (32, 96)])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_ssd_chunked_matches_reference(chunk, l, use_kernel):
    """(8, 128) runs 16 chunks: the reference's lax.map branch, the port's
    loop over chunks (without the kernel)."""
    arrays = _scan_inputs(2, l, 3, 8, 4, seed=chunk + l)
    jy, js = jm2.ssd_chunked(*(jnp.asarray(a) for a in arrays), chunk,
                             use_kernel=use_kernel)
    t = [torch.from_numpy(a) for a in arrays]
    y, s = mamba2.ssd_chunked(*t, chunk, use_kernel=use_kernel)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=CHUNKED_TOL,
                               atol=CHUNKED_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=CHUNKED_TOL,
                               atol=CHUNKED_TOL)
    ny, ns = mamba2.ssd_naive(*t)
    np.testing.assert_allclose(y.numpy(), ny.numpy(), rtol=CHUNKED_TOL,
                               atol=CHUNKED_TOL)
    np.testing.assert_allclose(s.numpy(), ns.numpy(), rtol=CHUNKED_TOL,
                               atol=CHUNKED_TOL)


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_ssd_chunked_per_group_matches_reference(use_kernel, g):
    """Four heads reading one or two groups of B and C (the kernel path
    passes them per group, the plain path repeats them per head)."""
    arrays = _scan_inputs(2, 64, 4, 8, 4, seed=40 + g, g=g)
    jy, js = jm2.ssd_chunked(*(jnp.asarray(a) for a in arrays), 16,
                             use_kernel=use_kernel)
    y, s = mamba2.ssd_chunked(*(torch.from_numpy(a) for a in arrays), 16,
                              use_kernel=use_kernel)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=CHUNKED_TOL,
                               atol=CHUNKED_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=CHUNKED_TOL,
                               atol=CHUNKED_TOL)


def test_configs_match_reference():
    """mamba2-370m and Jamba-v0.1 (full and reduced), field for field."""
    for arch in (ARCH, "jamba-v0.1-52b"):
        for a, b in ((jreduced(arch), reduced_config(arch)),
                     (jget(arch), get_config(arch))):
            for f in ("name", "num_layers", "d_model", "vocab_size", "family",
                      "norm", "tie_embeddings", "dtype", "num_heads",
                      "num_kv_heads", "head_dim", "d_ff", "activation",
                      "attn_every", "moe_every", "source", "verified"):
                assert getattr(a, f) == getattr(b, f), (arch, f)
            assert a.ssm.__dict__ == b.ssm.__dict__
            assert (a.moe is None) == (b.moe is None)
            if a.moe is not None:
                assert a.moe.__dict__ == b.moe.__dict__
            assert a.layer_kinds() == b.layer_kinds()
            assert a.ffn_kinds() == b.ffn_kinds()
            assert a.param_count() == b.param_count()
            assert jtf.period_plan(a) == transformer.period_plan(b)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_block_matches_reference(use_kernel):
    jcfg = jreduced(ARCH).replace(dtype="float32")
    cfg = reduced_config(ARCH).replace(dtype="float32")
    jparams = jm2.mamba2_init(jax.random.PRNGKey(4), cfg.d_model, jcfg.ssm,
                              jnp.float32)
    params = bridge.from_reference_params(jax.tree.map(np.asarray, jparams),
                                          device="cpu")
    x = np.random.default_rng(5).standard_normal((2, 64, cfg.d_model)) \
        .astype(np.float32)
    with jops.use_kernels(True):
        want = np.asarray(jm2.mamba2_block(jparams, jnp.asarray(x), jcfg.ssm,
                                           cfg.d_model, use_kernel=use_kernel))
    with torch.no_grad():
        got = mamba2.mamba2_block(params, torch.from_numpy(x), cfg.ssm,
                                  cfg.d_model, use_kernel=use_kernel)
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=BLOCK_TOL, atol=BLOCK_TOL)


def test_oracle_path_is_the_reference_oracle():
    """``use_kernels(False)`` sends ``ssd_intra_chunk`` to the oracle."""
    arrays = _ssd_inputs(1, 2, 16, 2, 8, 4, seed=9)
    t = [torch.from_numpy(a) for a in arrays]
    want = jref.ssd_intra_chunk_ref(*(jnp.asarray(a) for a in arrays))
    with ops.use_kernels(False):
        got = ops.ssd_intra_chunk(*t)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=KERNEL_TOL,
                                   atol=KERNEL_TOL)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    t = [torch.from_numpy(a) for a in _ssd_inputs(1, 2, 16, 2, 8, 4, seed=0)]
    xc, Bc, Cc, Ac, Acum = t
    with pytest.raises(TypeError):                       # dtype
        ssd.ssd_intra_chunk_kernel(xc.double(), Bc, Cc, Ac, Acum)
    with pytest.raises(ValueError):                      # rank
        ssd.ssd_intra_chunk_kernel(xc[0], Bc, Cc, Ac, Acum)
    with pytest.raises(ValueError):                      # B/C shapes
        ssd.ssd_intra_chunk_kernel(xc, Bc, Cc[..., :2], Ac, Acum)
    B3 = torch.zeros((*Bc.shape[:3], 3, Bc.shape[-1]))  # 3 groups, 2 heads
    with pytest.raises(ValueError):
        ssd.ssd_intra_chunk_kernel(xc, B3, B3, Ac, Acum)
    with pytest.raises(ValueError):                      # decay shape
        ssd.ssd_intra_chunk_kernel(xc, Bc, Cc, Ac, Acum[..., :8])
    with pytest.raises(ValueError):                      # device
        ssd.ssd_intra_chunk_kernel(*(a.to("meta") for a in t))
    with pytest.raises(NotImplementedError):             # no backward
        ssd.ssd_intra_chunk_kernel(xc.requires_grad_(), Bc, Cc, Ac, Acum)
