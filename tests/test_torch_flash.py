"""The port's flash attention against the JAX package, on the CPU.

* ``kernels.ref.flash_attention_plain`` (what the wrapper runs for CPU
  tensors: the CUDA kernel's arithmetic) matches the Pallas kernel in
  interpret mode and the reference's oracle at the reference's shapes
  (``tests/test_kernels.py``, rectangular KV with Sk = 2 Sq at hd 16 and
  128 included) and tolerances:
  2e-4 in fp32, 4e-2 in bf16 (p and the output are rounded to bf16);
* ``attention(use_flash=True)`` matches the JAX ``attention(use_flash=
  True)`` on the same weights and input within 1e-4 in fp32 (both
  accumulate in fp32, in other orders), with kernels on and off;
* the wrapper refuses what the kernel does not take, and CPU tensors
  never touch its launch counter;
* ``chip_smoke.flash_bf16_check``, which holds the bf16 tensor-core kernel
  on the card, passes the plain version against itself and fails an
  output whose p skipped the bf16 rounding or that lost a key.

The CUDA kernel itself runs only on the card (``chip_smoke.py``).
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_kernel as jflash
from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.models import attention

TOL = {"float32": 2e-4, "bfloat16": 4e-2}
ATTN_TOL = 1e-4


def _qkv(B, Sq, Sk, H, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, s, H, hd)).astype(np.float32)
            for s in (Sq, Sk, Sk)]


def _both(arrays, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


@pytest.mark.parametrize("B,Sq,Sk,H,hd", [(1, 64, 64, 2, 16), (2, 100, 100, 4, 32),
                                          (1, 256, 256, 1, 64), (1, 17, 17, 2, 8),
                                          (1, 32, 64, 2, 16), (1, 64, 128, 2, 128),
                                          (1, 40, 80, 2, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_and_oracle(B, Sq, Sk, H, hd, dtype):
    j, t = _both(_qkv(B, Sq, Sk, H, hd, seed=B * 100 + Sq), dtype)
    pallas = np.asarray(jflash(*j, q_tile=32, k_tile=32), np.float32)
    oracle = np.asarray(jref.flash_attention_ref(*j), np.float32)
    before = fa.LAUNCHES
    got = fa.flash_attention_kernel(*t)
    assert fa.LAUNCHES == before             # CPU tensors: plain version only
    assert got.dtype == t[0].dtype and tuple(got.shape) == (B, Sq, H, hd)
    tol = TOL[dtype]
    got = got.float().numpy()
    np.testing.assert_allclose(got, pallas, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, oracle, rtol=tol, atol=tol)
    # the port's oracle is the reference's oracle
    np.testing.assert_allclose(ref.flash_attention_ref(*t).float().numpy(),
                               oracle, rtol=tol, atol=tol)


@pytest.mark.parametrize("kernels", [True, False])
def test_attention_use_flash_matches_reference(kernels):
    B, S, d, H, n_kv, hd = 2, 40, 32, 4, 2, 8
    rng = np.random.default_rng(3)
    w = {"wq": (d, H * hd), "wk": (d, n_kv * hd), "wv": (d, n_kv * hd),
         "wo": (H * hd, d)}
    w = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in w.items()}
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    kw = dict(n_heads=H, n_kv=n_kv, head_dim=hd, rope_theta=10000.0,
              use_flash=True)
    with jops.use_kernels(kernels):
        want = np.asarray(jattn.attention({k: jnp.asarray(v) for k, v in w.items()},
                                          jnp.asarray(x), **kw))
    with ops.use_kernels(kernels):
        got = attention.attention({k: torch.from_numpy(v) for k, v in w.items()},
                                  torch.from_numpy(x), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=ATTN_TOL, atol=ATTN_TOL)
    # and the flash path is the same attention as the non-flash one
    plain = attention.attention({k: torch.from_numpy(v) for k, v in w.items()},
                                torch.from_numpy(x), **dict(kw, use_flash=False))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=ATTN_TOL,
                               atol=ATTN_TOL)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 8, 2, 16, seed=0))
    with pytest.raises(TypeError):                       # dtype
        fa.flash_attention_kernel(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):                       # mixed dtypes
        fa.flash_attention_kernel(q, k.bfloat16(), v)
    with pytest.raises(ValueError):                      # rank
        fa.flash_attention_kernel(q[0], k[0], v[0])
    with pytest.raises(ValueError):                      # Sk < Sq
        fa.flash_attention_kernel(q, k[:, :4], v[:, :4])
    with pytest.raises(ValueError):                      # k/v shapes
        fa.flash_attention_kernel(q, k, v[..., :8])
    with pytest.raises(ValueError):                      # device
        fa.flash_attention_kernel(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError):                      # mixed devices
        fa.flash_attention_kernel(q, k.to("meta"), v)
    with pytest.raises(NotImplementedError):             # no backward
        fa.flash_attention_kernel(q.requires_grad_(), k, v)


@pytest.mark.parametrize("fault", [None, "unrounded_p", "lost_key"])
def test_flash_bf16_check_has_teeth(fault):
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(1, 100, 130, 2, 64, seed=5))
    plain = ref.flash_attention_plain(q, k, v)
    got = plain
    if fault == "unrounded_p":               # p kept in fp32 before PV
        got = ref.flash_attention_plain(q.float(), k.float(),
                                        v.float()).to(torch.bfloat16)
    elif fault == "lost_key":                # one key's value never added
        v_lost = v.clone()
        v_lost[:, 40] = 0
        got = ref.flash_attention_plain(q, k, v_lost)
    ok, metrics = chip_smoke.flash_bf16_check(got, plain, q, k, v)
    assert ok == (fault is None), metrics
