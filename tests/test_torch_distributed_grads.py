"""Gradients through the distributed MoE bodies on 8 gloo ranks, on the CPU.

The setup is the reference's ``tests/distributed_scripts/fsedp_grad.py``
(``repro_torch.parallel.gradcheck``, which ``chip_smoke.py`` runs on the
card too) on that script's (2, 4) ``("data", "model")`` mesh.  That script
itself is not the oracle: under the installed JAX its ``jax.grad``
through ``shard_map`` raises ``ValueError: psum is a variant->invariant
collective`` (``vma``) before it compares anything.  Its second half runs:
``jax.grad`` of the single-device ``moe_capacity`` loss (here through the
reference's jnp oracle, ``use_kernels(False)``), and that is what every
rank is held to, at the script's own ``rtol=5e-3, atol=5e-4``.

The port runs the ring's stream / index / slice modes (forced plans; the
stream mode also with one-hot and sorted dispatch and under the dynamic
schedule), ``ep`` and ``tp``.  Each rank takes its share of the loss and
sums the parameter gradients over the mesh, as ``gradcheck`` says; the
setup is drop-free, so one device's gradients are the oracle.
"""
import numpy as np
import pytest

from repro_torch.parallel import gradcheck as gc

MESH = ((2, 4), ("data", "model"))
P_MODEL, N_DATA = 4, 2
B_GRP = gc.B // N_DATA
RTOL, ATOL = 5e-3, 5e-4
# (strategy, forced fse_dp mode, dispatch, schedule)
CASES = [("fse_dp", m, "onehot", "static") for m in ("stream", "index",
                                                      "slice")]
CASES += [("fse_dp", "stream", "sorted", "static"),
          ("fse_dp", "stream", "onehot", "dynamic"),
          ("ep", None, "onehot", "static"), ("tp", None, "onehot", "static")]


def _port_rank(rank, world, arrays):
    from repro_torch.parallel import collectives, meshctx

    mesh = meshctx.ProcessMesh.create(*MESH)
    out = {case: {k: g.numpy() for k, g in grads.items()}
           for case, grads in gc.rank_grads(mesh, arrays, CASES).items()}
    out["collectives"] = dict(collectives.COUNTS)
    return out


def _reference(arrays):
    """jax.grad of the single-device capacity loss (the second half of
    fsedp_grad.py)."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import MoEConfig as JMoE
    from repro.core import gating as jgating
    from repro.kernels import ops as jops
    from repro.models import moe as jmoe

    moe = JMoE(num_experts=gc.E, top_k=gc.K, d_expert=gc.DE,
               capacity_factor=gc.E / gc.K, micro_slices=2)

    def loss_ref(p, x):
        x2d = x.reshape(-1, gc.D)
        r = jgating.route(p["router"], x2d, top_k=gc.K)
        return jnp.sum(jmoe.moe_capacity(p, x2d, r, moe, "swiglu") ** 2)

    with jops.use_kernels(False):
        gp, gx = jax.grad(loss_ref, argnums=(0, 1))(
            gc.params(arrays, jnp.asarray), jnp.asarray(arrays["x"]))
    want = {k: np.asarray(gc.leaf(gp, k)) for k in gc.LEAVES}
    want["x"] = np.asarray(gx)
    return want


@pytest.fixture(scope="module")
def runs():
    from repro_torch.parallel import localrun
    arrays = gc.inputs()
    return localrun.run(_port_rank, 8, arrays), _reference(arrays)


@pytest.mark.parametrize("case", CASES, ids=gc.case_id)
def test_weight_gradients_match_single_device(runs, case):
    port, want = runs
    for rank, got in enumerate(port):
        for k in gc.LEAVES:
            np.testing.assert_allclose(got[gc.case_id(case)][k], want[k],
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"rank {rank} {k}")


@pytest.mark.parametrize("case", CASES, ids=gc.case_id)
def test_row_gradients_match_single_device(runs, case):
    """Each data group's rows' gradient, summed over its model ranks."""
    port, want = runs
    for rank, got in enumerate(port):
        dg = rank // P_MODEL
        np.testing.assert_allclose(got[gc.case_id(case)]["x"],
                                   want["x"][dg * B_GRP:(dg + 1) * B_GRP],
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f"rank {rank}")


def test_backward_communicated(runs):
    """The cases ran the distributed bodies: every rank issued each
    collective."""
    port, _ = runs
    for rank in port:
        c = rank["collectives"]
        assert all(c.get(op, 0) > 0 for op in ("ring_shift", "all_to_all",
                                                "psum", "all_gather"))
