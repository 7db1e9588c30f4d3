"""The port's shape structs (``launch.specs``: meta tensors) against the
reference's ``jax.eval_shape`` structs, for every arch x applicable
shape cell: the same leaves in the same order under the same keys, with
the same shapes and dtypes, and every port leaf on ``meta`` (nothing
allocated)."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.shapes import SHAPES as JSHAPES
from repro.launch import specs as jspecs
from repro.parallel import sharding as jshd
from repro_torch import tree
from repro_torch.configs import get_config, list_configs
from repro_torch.configs.shapes import SHAPE_ORDER, SHAPES, applicable
from repro_torch.launch import specs
from repro_torch.parallel import sharding as shd

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int32": torch.int32}


def _ref_leaves(struct):
    return [(jshd.path_key(p), tuple(x.shape), _DTYPES[np.dtype(x.dtype).name])
            for p, x in jax.tree_util.tree_flatten_with_path(struct)[0]]


def _port_leaves(struct):
    out = []
    for p, t in tree.leaves_with_path(struct):
        assert t.device.type == "meta", (p, t.device)
        out.append((shd.path_key(p), tuple(t.shape), t.dtype))
    return out


# the reference's params_struct traces its initializer (about 24 s for
# Qwen3-30B-A3B's 48 x 128 experts); its decode_structs calls it again,
# so every reference struct here reads one cached trace per config
_ref_params_struct = functools.lru_cache(maxsize=None)(jspecs.params_struct)


@pytest.fixture(autouse=True)
def _cached_reference_structs(monkeypatch):
    monkeypatch.setattr(jspecs, "params_struct", _ref_params_struct)


def _ref_params(arch):
    return _ref_leaves(jspecs.params_struct(jget_config(arch)))


@pytest.mark.parametrize("arch", list_configs())
def test_params_struct(arch):
    assert _port_leaves(specs.params_struct(get_config(arch))) == \
        _ref_params(arch)


CELLS = [(a, s) for a in list_configs() for s in SHAPE_ORDER
         if applicable(get_config(a), SHAPES[s])[0]]


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_cell_structs(arch, shape):
    cfg, jcfg = get_config(arch), jget_config(arch)
    sp, jsp = SHAPES[shape], JSHAPES[shape]
    got = specs.input_specs(cfg, sp)
    want = jspecs.input_specs(jcfg, jsp)
    assert _port_leaves(got) == _ref_leaves(want)
    if sp.kind == "decode":
        caches, token, cache_len = specs.decode_structs(cfg, sp)
        jc, jt, jl = jspecs.decode_structs(jcfg, jsp)
        assert _port_leaves((caches, token, cache_len)) == \
            _ref_leaves((jc, jt, jl))
    else:
        assert _port_leaves(specs.batch_struct(cfg, sp)) == \
            _ref_leaves(jspecs.batch_struct(jcfg, jsp))


def test_constants():
    assert (specs.WHISPER_TEXT_LEN, specs.WHISPER_MEMORY_LEN) == \
        (jspecs.WHISPER_TEXT_LEN, jspecs.WHISPER_MEMORY_LEN)
