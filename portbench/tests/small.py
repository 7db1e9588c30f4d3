"""Small configurations and contexts for the CPU tests: a cell of the
benchmark at reduced widths, with the configuration file's numbers
brought down to match (the tests only; no benchmark run uses them)."""
from __future__ import annotations

import dataclasses

import torch

from portbench import harness

SMALL = {"num_hidden_layers": 2, "hidden_size": 64, "num_attention_heads": 4,
         "head_dim": 16, "moe_intermediate_size": 32, "n_routed_experts": 8,
         "num_experts_per_tok": 2, "vocab_size": 512}


def small_config(conf: dict) -> dict:
    out = dict(conf)
    out.update(SMALL)
    out["num_key_value_heads"] = 2 if conf["num_key_value_heads"] < \
        conf["num_attention_heads"] else 4
    out["n_shared_experts"] = min(1, conf["n_shared_experts"])
    return out


def small_model_cfg(conf: dict):
    from repro_torch.configs import get_config
    base = get_config(conf["registry"])
    moe = dataclasses.replace(
        base.moe, num_experts=conf["n_routed_experts"],
        top_k=conf["num_experts_per_tok"],
        d_expert=conf["moe_intermediate_size"],
        num_shared_experts=conf["n_shared_experts"])
    return base.replace(num_layers=conf["num_hidden_layers"],
                        d_model=conf["hidden_size"],
                        num_heads=conf["num_attention_heads"],
                        num_kv_heads=conf["num_key_value_heads"],
                        head_dim=conf["head_dim"], d_ff=conf["hidden_size"],
                        vocab_size=conf["vocab_size"], moe=moe,
                        tie_embeddings=bool(conf["tie_word_embeddings"]),
                        dtype="float32")


def small_context(cell_name: str, seed: int = 3, seconds: float = 1.0,
                  trace: bool = False, mix_update=None, cell_update=None,
                  **kw) -> harness.Context:
    """A CPU context for ``cell_name``: float32 weights at small widths,
    short prompts and outputs so a second of serving finishes requests."""
    harness.set_cache_dirs()
    torch.set_num_threads(2)
    cell, conf, mix = harness.load(cell_name, harness.benchmark())
    conf = small_config(conf)
    cell = dict(cell, **(cell_update or {}))
    mix = dict(mix, **(mix_update or {}))
    cfg = small_model_cfg(conf)
    return harness.Context(cell_name, cell, conf, mix, seed, seconds, trace,
                           device=torch.device("cpu"), model_cfg=cfg,
                           t_start=harness.now(), **kw)


SHORT_SERVING = {"prompt": {"dist": "lognormal", "median": 12, "sigma": 0.5,
                            "min": 4, "max": 40},
                 "output": {"dist": "uniform", "min": 4, "max": 12}}
