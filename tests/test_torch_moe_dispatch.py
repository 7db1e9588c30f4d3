"""Capacity dispatch and combine through ``kernels.moe_dispatch``.

On the CPU the wrappers run their plain versions: the gather gives the
one-hot einsum's rows bit for bit (zero rows included), the combine gives
``scatter_combine(...).to(dtype)`` bit for bit and stays within fp32
rounding of ``one_hot_combine`` with overflowed choices, a token's output
bits do not depend on its batch companions, ``moe_hybrid`` stays
``moe_capacity``'s bits, a call under autograd keeps the one-hot products
(and counts in ``moe.ONE_HOT_CALLS``), and no kernel launch is counted.

Tests marked ``chip`` hold each CUDA kernel bit for bit to its plain
version on the card, at the benchmark cells' shapes, with overflow, at odd
widths and through a CUDA graph; they skip without a card:

    PYTHONPATH=src python -m pytest tests/test_torch_moe_dispatch.py -m chip
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.core import gating, trajectory
from repro_torch.kernels import moe_dispatch as kmd
from repro_torch.kernels import ops as kops
from repro_torch.models import moe

BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
DTYPES = [torch.float32, torch.bfloat16]
DTYPE_IDS = ["fp32", "bf16"]

# (T, E, C, k, d, skew): skew > 0 crowds the low experts, so that some
# choices overflow C and some rows stay empty
CASES = [(9, 4, 2, 2, 16, 2.0), (13, 8, 6, 3, 24, 1.5),
         (33, 8, 66, 2, 7, 0.0), (20, 6, 5, 2, 9, 3.0)]
CASE_IDS = ["overflow", "overflow_k3", "drop_free_odd_d", "overflow_odd_d"]


def _routing(T, E, k, seed=0, skew=0.0, dtype=torch.float32, device="cpu"):
    """Top-k choices and renormalised weights drawn by numpy, so that a
    token's routing is its own whatever the batch."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((T, E)) + skew * np.linspace(1.0, 0.0, E)
    idx = np.argsort(-logits, axis=1, kind="stable")[:, :k]
    w = rng.random((T, k)) + 0.1
    w = w / w.sum(1, keepdims=True)
    return _as_routing(idx, w, E, dtype, device)


def _as_routing(idx, w, E, dtype, device="cpu"):
    indices = torch.as_tensor(np.asarray(idx), dtype=torch.int64)
    weights = torch.as_tensor(np.asarray(w), dtype=torch.float32).to(dtype)
    combine = torch.zeros(indices.shape[0], E, dtype=dtype).scatter_(
        1, indices, weights)
    return gating.Routing(indices.to(device), weights.to(device),
                          combine.float().to(device), combine.to(device))


@pytest.fixture
def card():
    """The CUDA card for a test marked ``chip``; decided when the test
    runs, never while the module is imported, and a skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return torch.device("cuda", 0)


def _same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(BITS[a.dtype]), b.view(BITS[b.dtype]))


def _x(T, d, dtype, seed=1, device="cpu"):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((T, d)).astype(
        np.float32)).to(dtype).to(device)


def _ye(E, C, d, seed=2, device="cpu"):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((E, C, d)).astype(
        np.float32)).to(device)


# ---------------------------------------------------------------------------
# CPU: the wrappers' plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_gather_gives_one_hot_einsum_rows(case, dtype):
    T, E, C, k, d, skew = case
    r = _routing(T, E, k, skew=skew, dtype=dtype)
    x = _x(T, d, dtype)
    tables = moe.dispatch_tables(r, T, E, C)
    got = kmd.gather_dispatch_kernel(x, tables.idx)
    dispatch, _ = moe.dispatch_masks(r, T, E, C)
    want = torch.einsum("tec,td->ecd", dispatch.to(dtype), x)
    assert _same_bits(got, want)
    empty = tables.idx == T
    assert empty.any() and _same_bits(got[empty], torch.zeros_like(
        got[empty]))


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_combine_is_scatter_combine_and_near_one_hot(case, dtype):
    T, E, C, k, d, skew = case
    r = _routing(T, E, k, skew=skew, dtype=dtype)
    ye = _ye(E, C, d)
    tables = moe.dispatch_tables(r, T, E, C)
    overflowed = tables.rows == E * C
    assert overflowed.any() == (skew > 0)
    got = kmd.scatter_combine_kernel(ye, tables.rows, tables.weights, dtype)
    want = kmd.scatter_combine(ye, tables.rows, tables.weights).to(dtype)
    assert _same_bits(got, want)
    # fp32: k products rounded once each and k adds, against the one-hot
    # product's sum over E of the same k exact-product partials
    got32 = kmd.scatter_combine_kernel(ye, tables.rows, tables.weights,
                                       torch.float32)
    _, combine = moe.dispatch_masks(r, T, E, C)
    one_hot = moe.one_hot_combine(combine, ye)
    size = kmd.scatter_combine(ye.abs(), tables.rows, tables.weights.abs())
    assert ((got32 - one_hot).abs() <= (k + 1) * 2.0 ** -24 * size).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("how", ["permuted", "replaced"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_token_bits_independent_of_batch(dtype, how, seed):
    """Drop-free capacity (serving's): a token's output keeps its bits at
    another row among other tokens.  The expert FFN here is elementwise,
    so the check holds the dispatch and the combine alone."""
    T, E, k, d = 24, 8, 3, 16
    C = T * k
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.permutation(E)[:k] for _ in range(T)])
    w = rng.random((T, k)) + 0.1
    x = _x(T, d, dtype, seed=seed + 10)
    scale = torch.linspace(0.5, 2.0, E)
    params = {"w_up": torch.zeros(E, d, 1), "w_down": torch.zeros(E, 1, d)}

    def run(x_, idx_, w_):
        with torch.no_grad():
            return moe._capacity_rows(
                params, x_, _as_routing(idx_, w_, E, dtype), E, C, None,
                lambda xe: torch.tanh(xe.float() * scale[:, None, None]))

    y = run(x, idx, w)
    if how == "permuted":
        perm = rng.permutation(T)
        y2 = run(x[torch.from_numpy(perm)], idx[perm], w[perm])
        assert _same_bits(y2, y[torch.from_numpy(perm)])
        return
    half = T // 2
    at = rng.permutation(T)[:half]
    x2 = _x(T, d, dtype, seed=seed + 20)
    idx2 = np.stack([rng.permutation(E)[:k] for _ in range(T)])
    w2 = rng.random((T, k)) + 0.1
    x2[torch.from_numpy(at)] = x[:half]
    idx2[at], w2[at] = idx[:half], w[:half]
    y2 = run(x2, idx2, w2)
    assert _same_bits(y2[torch.from_numpy(at)], y[:half])


def _moe_case(T=24, d=16, E=8, m=32, k=2, cf=1.0, seed=5,
              dtype=torch.float32):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=0.3):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(dtype)
    p = {"router": {"w_router": t(d, E, scale=1.0)}, "w_up": t(E, d, m),
         "w_down": t(E, m, d), "w_gate": t(E, d, m)}
    cfg = MoEConfig(num_experts=E, top_k=k, d_expert=m, capacity_factor=cf)
    return t(T, d, scale=1.0), p, cfg


@pytest.mark.parametrize("hot", [1, 3])
@pytest.mark.parametrize("schedule", ["static", "dynamic"])
@pytest.mark.parametrize("cf", [1.0, 8.0], ids=["overflow", "drop_free"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_hybrid_is_capacity_bits_through_tables(dtype, cf, schedule, hot):
    x, p, cfg = _moe_case(cf=cf, dtype=dtype)
    sched = trajectory.DYNAMIC if schedule == "dynamic" else None
    before = moe.ONE_HOT_CALLS
    with torch.no_grad():
        r = gating.route(p["router"], x, top_k=cfg.top_k)
        cap = moe.moe_capacity(p, x, r, cfg, "swiglu", schedule=sched)
        hyb = moe.moe_hybrid(p, x, r, cfg, "swiglu", hot_experts=hot,
                             schedule=sched)
    assert moe.ONE_HOT_CALLS == before
    assert cap.dtype == dtype and _same_bits(hyb, cap)


def _one_hot_by_hand(p, x, cfg, activation="swiglu"):
    """The one-hot products as ``moe_capacity`` ran them before the
    kernels moved the rows."""
    T = x.shape[0]
    E, C = cfg.num_experts, cfg.capacity_rows(T)
    r = gating.route(p["router"], x, top_k=cfg.top_k)
    dispatch, combine = moe.dispatch_masks(r, T, E, C)
    xe = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), x)
    ye = moe._expert_ffn(p, xe.contiguous(), activation)
    return moe.one_hot_combine(combine, ye).to(x.dtype)


@pytest.mark.parametrize("wrt", ["params", "x"])
@pytest.mark.parametrize("cf", [1.0, 8.0], ids=["overflow", "drop_free"])
def test_autograd_keeps_one_hot_products(cf, wrt):
    x, p, cfg = _moe_case(cf=cf)
    leaves = [x] if wrt == "x" else [p["router"]["w_router"], p["w_up"],
                                      p["w_down"], p["w_gate"]]

    def grads(fn):
        ls = [t.detach().clone().requires_grad_(True) for t in leaves]
        q = {"router": {"w_router": p["router"]["w_router"]}, **{
            k_: v for k_, v in p.items() if k_ != "router"}}
        xx = ls[0] if wrt == "x" else x
        if wrt == "params":
            q["router"]["w_router"] = ls[0]
            q["w_up"], q["w_down"], q["w_gate"] = ls[1:]
        y = fn(q, xx)
        return y, torch.autograd.grad((y * y).sum(), ls)

    before = moe.ONE_HOT_CALLS
    y, g = grads(lambda q, xx: moe.moe_capacity(
        q, xx, gating.route(q["router"], xx, top_k=cfg.top_k), cfg,
        "swiglu"))
    assert moe.ONE_HOT_CALLS == before + 1
    y_ref, g_ref = grads(lambda q, xx: _one_hot_by_hand(q, xx, cfg))
    assert _same_bits(y.detach(), y_ref.detach())
    assert all(_same_bits(a, b) for a, b in zip(g, g_ref))


@pytest.mark.parametrize("mode", ["no_grad", "grad_mode_nothing_recorded",
                                  "kernels_off"])
def test_which_calls_take_the_tables(mode):
    """With kernels on and nothing recorded, the rows move through the
    tables (no one-hot call counted, the no_grad call's bits); with
    kernels off the one-hot oracle runs and counts nothing."""
    x, p, cfg = _moe_case()
    before = moe.ONE_HOT_CALLS
    with torch.no_grad():
        r = gating.route(p["router"], x, top_k=cfg.top_k)
        want = moe.moe_capacity(p, x, r, cfg, "swiglu")
    if mode == "no_grad":
        got = want
    elif mode == "grad_mode_nothing_recorded":
        got = moe.moe_capacity(p, x, r, cfg, "swiglu")
    else:
        with kops.use_kernels(False):
            got = moe.moe_capacity(p, x, r, cfg, "swiglu")
            oracle = _one_hot_by_hand(p, x, cfg)
        assert _same_bits(got, oracle)
        want = got
    assert moe.ONE_HOT_CALLS == before and _same_bits(got, want)


def test_wrappers_check_shapes():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        kmd.gather_dispatch_kernel(x, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError):
        kmd.scatter_combine_kernel(torch.zeros(2, 3, 8),
                                   torch.zeros(4, 2, dtype=torch.int64),
                                   torch.zeros(4, 3), torch.float32)


def test_no_kernel_launch_counted_on_cpu():
    x, p, cfg = _moe_case(cf=8.0, dtype=torch.bfloat16)
    with torch.no_grad():
        r = gating.route(p["router"], x, top_k=cfg.top_k)
        moe.moe_capacity(p, x, r, cfg, "swiglu")
        moe.moe_hybrid(p, x, r, cfg, "swiglu", hot_experts=2)
    assert kmd.LAUNCHES == 0 and kmd.CAPTURED == 0


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------

# (T, E, C, k, d, skew): granite scoring, DeepSeek decode, DeepSeek's
# drop-free chunk pass; finite capacity with overflow; odd widths (2- and
# 4-byte words, the combine's scalar columns)
CARD_CASES = [(4096, 32, 1280, 8, 1024, 0.0), (8, 64, 48, 6, 2048, 0.0),
              (128, 64, 768, 6, 2048, 0.0), (512, 8, 64, 2, 1024, 3.0),
              (96, 8, 30, 2, 1023, 1.0), (96, 8, 30, 2, 1022, 1.0),
              (96, 8, 30, 2, 1021, 1.0)]
CARD_IDS = ["score", "decode", "chunk", "overflow", "d1023", "d1022",
            "d1021"]


@pytest.mark.chip
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("case", CARD_CASES, ids=CARD_IDS)
def test_kernels_hold_plain_bits_on_card(case, dtype, card):
    T, E, C, k, d, skew = case
    r = _routing(T, E, k, skew=skew, dtype=dtype, device=card)
    tables = moe.dispatch_tables(r, T, E, C)
    assert bool((tables.rows == E * C).any()) == (skew > 0)
    x = _x(T, d, dtype, device=card)
    ye = _ye(E, C, d, device=card)
    n = kmd.LAUNCHES
    xe = kmd.gather_dispatch_kernel(x, tables.idx)
    y = kmd.scatter_combine_kernel(ye, tables.rows, tables.weights, dtype)
    torch.cuda.synchronize()
    assert kmd.LAUNCHES == n + 2
    assert _same_bits(xe, kmd.gather_dispatch(x, tables.idx))
    assert _same_bits(y, kmd.scatter_combine(ye, tables.rows, tables.weights)
                      .to(dtype))
    if T * E * C <= 2 ** 28:      # the one-hot einsum's masks fit easily
        dispatch, _ = moe.dispatch_masks(r, T, E, C)
        assert torch.equal(xe, torch.einsum("tec,td->ecd",
                                            dispatch.to(dtype), x))


@pytest.mark.chip
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_kernels_capture_and_replay_on_card(dtype, card):
    T, E, C, k, d = 8, 64, 48, 6, 2048
    r = _routing(T, E, k, dtype=dtype, device=card)
    tables = moe.dispatch_tables(r, T, E, C)
    x = _x(T, d, dtype, device=card)
    ye = _ye(E, C, d, device=card)
    kmd.gather_dispatch_kernel(x, tables.idx)          # load before capture
    kmd.scatter_combine_kernel(ye, tables.rows, tables.weights, dtype)
    torch.cuda.synchronize()
    n, c = kmd.LAUNCHES, kmd.CAPTURED
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        xe = kmd.gather_dispatch_kernel(x, tables.idx)
        y = kmd.scatter_combine_kernel(ye, tables.rows, tables.weights, dtype)
    assert kmd.CAPTURED == c + 2 and kmd.LAUNCHES == n
    x.copy_(_x(T, d, dtype, seed=7, device=card))
    ye.copy_(_ye(E, C, d, seed=8, device=card))
    g.replay()
    torch.cuda.synchronize()
    assert kmd.LAUNCHES == n and kmd.CAPTURED == c + 2
    assert _same_bits(xe, kmd.gather_dispatch(x, tables.idx))
    assert _same_bits(y, kmd.scatter_combine(ye, tables.rows, tables.weights)
                      .to(dtype))


@pytest.mark.chip
@pytest.mark.parametrize("cf", [1.0, 8.0], ids=["overflow", "drop_free"])
def test_moe_capacity_takes_the_kernels_on_card(cf, card):
    """A MoE layer under no_grad moves its rows through the two kernels
    and keeps no one-hot product; hybrid gives its bits."""
    x, p, cfg = _moe_case(T=64, d=64, E=8, m=64, k=2, cf=cf,
                          dtype=torch.bfloat16)
    x = x.to(card)
    p = {"router": {"w_router": p["router"]["w_router"].to(card)},
         **{k_: v.to(card) for k_, v in p.items() if k_ != "router"}}
    n, before = kmd.LAUNCHES, moe.ONE_HOT_CALLS
    with torch.no_grad():
        r = gating.route(p["router"], x, top_k=cfg.top_k)
        cap = moe.moe_capacity(p, x, r, cfg, "swiglu")
        hyb = moe.moe_hybrid(p, x, r, cfg, "swiglu", hot_experts=3)
    torch.cuda.synchronize()
    assert kmd.LAUNCHES == n + 4 and moe.ONE_HOT_CALLS == before
    assert _same_bits(hyb, cap)
