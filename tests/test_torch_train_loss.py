"""Gradients of the training loss: port vs ``jax.grad`` of the reference's
``api.loss_fn``, every leaf, on the CPU (the LM families here, the SSM
ones and Whisper in ``test_torch_train_families.py``).

Reduced configs in fp32, JAX-initialized weights bridged leaf for leaf,
the same numpy-seeded batches.  The MoE families run under ``capacity``
(the streamed_moe path: the port's plain version with its straight-through
backward, the reference's jnp oracle under ``use_kernels(False)``), granite
with one-hot and with sorted dispatch; DeepSeek adds a shared expert,
Jamba interleaves Mamba-2, attention, MoE and dense layers, InternVL2
puts prefix embeddings in front, Whisper is the encoder-decoder family,
and mamba2-370m runs 512 positions, 16 chunks: the per-chunk path whose
chunks are recomputed in the backward.  Each with ``remat`` off and on.

Tolerance: every leaf within GRAD_RTOL of its own reference values plus
GRAD_ATOL times the leaf's largest reference magnitude: the reference's
gradient tolerance for streamed_moe (``rtol=2e-4, atol=2e-5``,
``tests/test_streamed_moe_parity.py``), the absolute part scaled to the
leaf so that leaves of small gradients are held as tightly as large ones.
The loss itself within 1e-5 relative.  ``remat`` on == off: the loss bit
for bit, each leaf's gradient within 1e-6 of its largest magnitude (fp32
reassociation where contributions meet).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jreduced
from repro.kernels import ops as jops
from repro.models import api as japi
from repro.models import moe as jmoe
from repro_torch import bridge, tree
from repro_torch.configs import reduced_config
from repro_torch.models import api
from repro_torch.models import moe as moe_mod

GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5
LOSS_RTOL = 1e-5
REMAT_TOL = 1e-6
# (arch, MoE spec, dispatch, B, S); the SSM families and Whisper are in
# test_torch_train_families.py, which runs these tests on its own cases
CASES = [("granite-moe-1b-a400m", "capacity", "onehot", 2, 32),
         ("granite-moe-1b-a400m", "capacity", "sorted", 2, 32),
         ("deepseek-moe-16b", "capacity", "onehot", 2, 32),
         ("internvl2-2b", None, "onehot", 2, 16)]


def _ids(case):
    return f"{case[0]}-{case[2]}" if case[1] else case[0]


def _batch(cfg, B, S, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S))
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -1)], axis=1)
    batch = {"tokens": tokens, "labels": labels}
    if cfg.frontend is not None and cfg.frontend.num_prefix_tokens:
        batch["prefix_embeds"] = rng.standard_normal(
            (B, cfg.frontend.num_prefix_tokens, cfg.d_model)
        ).astype(np.float32)
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.standard_normal(
            (B, 12, cfg.d_model)).astype(np.float32)
    return batch


def _reference(arch, spec, disp, batch):
    jcfg = jreduced(arch).replace(dtype="float32")
    jparams = japi.init_params(jax.random.PRNGKey(0), jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with jops.use_kernels(False), jmoe.use_sorted_dispatch(disp == "sorted"):
        (loss, _), grads = jax.value_and_grad(
            lambda p: japi.loss_fn(p, jbatch, jcfg, spec=spec),
            has_aux=True)(jparams)
    params = bridge.from_reference_params(jax.tree.map(np.asarray, jparams),
                                          device="cpu")
    return params, float(loss), {k: np.asarray(v) for k, v in
                                 tree.leaves_with_path(grads)}


def _port(params, cfg, spec, disp, batch, remat):
    leaves = [p.requires_grad_(True) for p in tree.leaves(params)]
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with moe_mod.use_sorted_dispatch(disp == "sorted"):
        loss, _ = api.loss_fn(params, tbatch, cfg, spec=spec, remat=remat)
        grads = torch.autograd.grad(loss, leaves)
    return loss.item(), grads


def make_case(request):
    arch, spec, disp, B, S = request.param
    cfg = reduced_config(arch).replace(dtype="float32")
    batch = _batch(cfg, B, S)
    params, jloss, jgrads = _reference(arch, spec, disp, batch)
    runs = {remat: _port(params, cfg, spec, disp, batch, remat)
            for remat in (False, True)}
    return params, jloss, jgrads, runs


case = pytest.fixture(scope="module", params=CASES, ids=_ids)(make_case)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_fn_gradients_match_reference(case, remat):
    params, jloss, jgrads, runs = case
    loss, grads = runs[remat]
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
    paths = [k for k, _ in tree.leaves_with_path(params)]
    assert sorted(paths) == sorted(jgrads)
    for path, g in zip(paths, grads):
        want = jgrads[path]
        assert g.shape == want.shape, path
        np.testing.assert_allclose(
            g.numpy(), want, rtol=GRAD_RTOL,
            atol=GRAD_ATOL * max(np.abs(want).max(), 1e-30), err_msg=path)


def test_remat_equals_no_remat(case):
    """The recompute runs the same operations on the same operands: the
    same loss bit for bit and each leaf's gradient within REMAT_TOL of its
    largest magnitude (a leaf that several parts of the graph reach, such
    as a tied embedding, may add its contributions in another order)."""
    *_, runs = case
    assert runs[False][0] == runs[True][0]
    for a, b in zip(runs[False][1], runs[True][1]):
        assert (a - b).abs().max() <= REMAT_TOL * b.abs().max()
