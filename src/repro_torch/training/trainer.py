"""Training loop (port of ``repro.training.trainer``): an AdamW step over
``api.loss_fn``'s gradients, optional int8 gradient compression with
error feedback, checkpoints with auto-resume.

Fault-tolerance contract: a checkpoint holds the parameters, the
optimizer state and the compression residual; the data pipeline is a
pure function of the step; so a run that crashes resumes from its last
published checkpoint onto the same trajectory (a crash is simulated with
``crash_at_step``).  Parameters are leaf tensors that require grad; the
optimizer writes each step's update into them in place.  The run is on
``cuda`` unless ``device="cpu"``.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from repro_torch import tree
from repro_torch.checkpointing import manager as ckpt
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.optim import adamw, compress


@dataclass
class TrainConfig:
    lr: float = 3e-4
    warmup: int = 20
    total_steps: int = 200
    weight_decay: float = 0.1
    max_grad_norm: float = 1.0
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep_ckpts: int = 3
    grad_compress_bits: int = 0       # 0 = off; 8 = int8 + error feedback
    moe_spec: Optional[Any] = None    # MoE ExecutionSpec / strategy name
    moe_impl: Optional[str] = None    # deprecated alias for moe_spec
    remat: bool = False
    log_every: int = 10
    state_dtype: str = "float32"


_MOE_IMPL_WARNED = False


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """-> step_fn(params, opt_state, batch, residual) -> (params,
    opt_state, residual, metrics): one forward and backward through
    ``api.loss_fn`` and one AdamW update of ``params`` in place.  Metrics
    are tensors: loss, ce, aux and grad_norm."""
    global _MOE_IMPL_WARNED
    sched = adamw.cosine_schedule(tcfg.lr, tcfg.warmup, tcfg.total_steps)
    if tcfg.moe_impl is not None and not _MOE_IMPL_WARNED:
        _MOE_IMPL_WARNED = True
        warnings.warn("TrainConfig.moe_impl is deprecated; use "
                      "TrainConfig.moe_spec (see README migration table)",
                      DeprecationWarning, stacklevel=2)
    spec = tcfg.moe_spec if tcfg.moe_spec is not None else tcfg.moe_impl

    def step_fn(params, opt_state, batch, residual):
        leaves = tree.leaves(params)
        loss, metrics = api.loss_fn(params, batch, cfg, spec=spec,
                                    remat=tcfg.remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = tree.unflatten(params, [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)])
        if tcfg.grad_compress_bits:
            grads, residual = compress.compress_tree(
                grads, residual, bits=tcfg.grad_compress_bits)
        params, opt_state, om = adamw.apply(
            params, grads, opt_state, lr=sched,
            weight_decay=tcfg.weight_decay, max_grad_norm=tcfg.max_grad_norm)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, residual, dict(metrics, loss=loss.detach(),
                                                 **om)

    return step_fn


@dataclass
class TrainResult:
    losses: list = field(default_factory=list)
    final_step: int = 0
    resumed_from: Optional[int] = None
    wall_time: float = 0.0


def _trainable(params):
    for p in tree.leaves(params):
        p.requires_grad_(True)
    return params


def train(cfg: ModelConfig, dcfg: DataConfig, tcfg: TrainConfig,
          *, seed: int = 0, hooks: Optional[Callable[[int, dict], None]] = None,
          crash_at_step: Optional[int] = None, device=None) -> TrainResult:
    """Run (or resume from ``tcfg.ckpt_dir``) training.  ``hooks(step,
    metrics as floats)`` runs at each logged step.  ``crash_at_step``
    simulates preemption: the run raises before that step."""
    device = resolve_device(device)
    params = _trainable(api.init_params(cfg, seed=seed, device=device))
    opt_state = adamw.init(params, tcfg.state_dtype)
    residual = tree.map(lambda p: torch.zeros(p.shape, device=device),
                        params) if tcfg.grad_compress_bits \
        else torch.zeros((), device=device)
    start = 0
    resumed = None
    if tcfg.ckpt_dir and ckpt.latest_step(tcfg.ckpt_dir) is not None:
        state = {"params": params, "opt": opt_state, "residual": residual}
        state, start, _ = ckpt.restore(tcfg.ckpt_dir, state)
        params = _trainable(state["params"])
        opt_state, residual = state["opt"], state["residual"]
        resumed = start

    data = SyntheticLM(dcfg)
    step_fn = make_train_step(cfg, tcfg)
    result = TrainResult(resumed_from=resumed)
    t0 = time.time()

    for step in range(start, tcfg.total_steps):
        if crash_at_step is not None and step == crash_at_step:
            raise RuntimeError(f"simulated preemption at step {step}")
        batch = {k: torch.from_numpy(v).long().to(device)
                 for k, v in data.batch(step).items()}
        params, opt_state, residual, metrics = step_fn(params, opt_state,
                                                       batch, residual)
        if step % tcfg.log_every == 0 or step == tcfg.total_steps - 1:
            result.losses.append((step, float(metrics["loss"])))
            if hooks:
                hooks(step, {k: float(v) for k, v in metrics.items()})
        if tcfg.ckpt_dir and ((step + 1) % tcfg.ckpt_every == 0
                              or step == tcfg.total_steps - 1):
            state = {"params": params, "opt": opt_state, "residual": residual}
            ckpt.save(tcfg.ckpt_dir, step + 1, state)
            ckpt.gc_old(tcfg.ckpt_dir, tcfg.keep_ckpts)

    result.final_step = tcfg.total_steps
    result.wall_time = time.time() - t0
    result.params = params  # type: ignore[attr-defined]
    return result
