"""Every public name and parameter of the reference package ``src/repro``
has a counterpart in the port ``src/repro_torch``, or stands in ``STATED``
with the reason it has none.

The reference is read with ``ast``, so nothing of JAX loads.  For each of
its module files: the public top-level names (definitions, assignments,
and names imported from inside the package; a submodule only where a
package ``__init__`` exports it), each public class's public methods, and
the parameter names of each public function and method and of each public
class's constructor (its ``__init__``, or its fields for a dataclass or a
``NamedTuple``).  The port's counterpart module is imported on the CPU and
looked up with ``getattr`` and ``inspect.signature``, so inherited methods
count.  A name the reference binds to a module must be a module in the
port, and one it binds to a function, class or value must not be.

Keys: ``"core.autotune:pick_mode"``, ``"core.autotune:Plan.breakdown"``,
``"core.gating:route(key)"``, ``"serving.megastep:MegaStep(max_ctx)"``,
``"kernels.ops:streamed_moe(**kw)"``; a package's own names without a
module part after the package (``"kernels:ops"``).

    PYTHONPATH=src python -m pytest tests/test_torch_surface.py
"""
import ast
import functools
import importlib
import inspect
import pathlib

import pytest

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
REF = SRC / "repro"
FILES = sorted(p.relative_to(REF).as_posix() for p in REF.rglob("*.py"))

_KEY = "a torch.Generator (or an int seed) takes the JAX PRNG key's place"
_TILES = ("Pallas VMEM tiling; the port's tiles are Hopper settings by name "
          "that plan_kernel_tiles picks (kernels.streamed_moe.TILE_SETTINGS)")
_TILE_FN = ("the port prices its Hopper settings by x_dtype / weight_dtype "
            "names, not element bytes")
_XLA = ("reads XLA's compiled cost or HLO; the port counts the bytes its "
        "collectives move (analysis.step_cost)")
_PINS = "XLA layout pin; the port's mesh steps pin no layout"
_SHARD_MAP = ("jax shard_map with the replication checker off; the port's "
              "bodies run on torch.distributed over a ProcessMesh")

# "module:name" or "module:func(param)" -> why the port has no counterpart
STATED = {
    # Pallas tiling and interpret mode
    "kernels.streamed_moe:DEFAULT_TOKEN_TILE": _TILES,
    "kernels.streamed_moe:VMEM_BLOCK_BYTES": _TILES,
    "kernels.streamed_moe:fit_tile": _TILES,
    "kernels.streamed_moe:streamed_moe_kernel(token_tile)": _TILES,
    "kernels.streamed_moe:streamed_moe_kernel(dmodel_tile)": _TILES,
    "kernels.streamed_moe:streamed_moe_kernel(dexpert_tile)": _TILES,
    "kernels.streamed_moe:streamed_moe_kernel(interpret)":
        "Pallas interpret mode; on a CPU tensor the wrapper runs its plain "
        "version",
    "kernels.flash_attention:flash_attention_kernel(q_tile)":
        "Pallas block size; the port's tiles are fixed per head dim",
    "kernels.flash_attention:flash_attention_kernel(k_tile)":
        "Pallas block size; the port's tiles are fixed per head dim",
    "kernels.flash_attention:flash_attention_kernel(interpret)":
        "Pallas interpret mode; on a CPU tensor the wrapper runs its plain "
        "version",
    "kernels.ssd:ssd_intra_chunk_kernel(interpret)":
        "Pallas interpret mode; on a CPU tensor the wrapper runs its plain "
        "version",
    "kernels.ops:streamed_moe(**kw)":
        "Pallas tile keywords; the port's dispatch names its keywords "
        "(tiles=, the 8-bit scales)",
    "kernels.ops:flash_attention(**kw)":
        "Pallas tile keywords; the port's tiles are fixed per head dim",
    "kernels.ops:ssd_intra_chunk(**kw)":
        "Pallas interpret keyword; the port's dispatch takes body= only",
    "kernels:streamed_moe":
        "in the port this name is the kernel module; the function is "
        "ops.streamed_moe",
    "kernels:flash_attention":
        "in the port this name is the kernel module; the function is "
        "ops.flash_attention",
    # the TPU tile model of the planner
    "core.autotune:tile_vmem_bytes": _TILES,
    "core.autotune:kernel_tile_cost":
        "the TPU tile model; the port's is tile_cost over Hopper settings",
    "core.autotune:HardwareProfile.from_tpu":
        "TPU constants; the port's card is CardProfile.detect()",
    "core.autotune:default_tiles(d)":
        "the port's default setting depends on C and the dtypes only",
    "core.autotune:default_tiles(m)":
        "the port's default setting depends on C and the dtypes only",
    "core.autotune:default_tiles(dtype_bytes)": _TILE_FN,
    "core.autotune:default_tiles(weight_bytes)": _TILE_FN,
    "core.autotune:plan_kernel_tiles(dtype_bytes)": _TILE_FN,
    "core.autotune:plan_kernel_tiles(weight_bytes)": _TILE_FN,
    "core.autotune:measured_kernel_tiles(dtype_bytes)": _TILE_FN,
    "core.autotune:measured_kernel_tiles(weight_bytes)": _TILE_FN,
    "core.autotune:kernel_opts_for(dtype_bytes)": _TILE_FN,
    "core.autotune:kernel_opts_for(weight_bytes)": _TILE_FN,
    # XLA's cost analysis and layouts
    "launch.analysis:ICI_BW": "TPU interconnect constant",
    "launch.analysis:VMEM_BYTES": "TPU VMEM constant",
    "launch.analysis:cost_dict": _XLA,
    "launch.analysis:lowering_cost": _XLA,
    "launch.analysis:collective_bytes(hlo_text)": _XLA,
    "parallel.sharding:constrain_batch_only": _PINS,
    "parallel.sharding:constrain_kv_seq": _PINS,
    "parallel.sharding:constrain_seq_sharded": _PINS,
    # shard_map and mesh axes
    "core.fse_dp:shard_map": _SHARD_MAP,
    "core.baselines:shard_map": _SHARD_MAP + " (core.fse_dp's, imported)",
    "core.fse_dp:pmean_all(axes)":
        "torch.distributed averages over a ProcessMesh (pmean_all(x, mesh))",
    # compiled-segment cache and the combine
    "serving.megastep:get_megastep":
        "a captured graph binds one engine's buffers, so a process-wide "
        "cache would replay another engine's addresses; Engine.megastep()",
    "serving.megastep:MegaStep(max_ctx)":
        "the segments take max_ctx from the engine's paged pool",
    "models.moe:scatter_combine(idx)":
        "the port's combine is a deterministic gather (sorted dispatch)",
    "models.moe:scatter_combine(wts)":
        "the port's combine is a deterministic gather (sorted dispatch)",
    "models.moe:scatter_combine(T)":
        "the port's combine is a deterministic gather (sorted dispatch)",
    # the JAX PRNG key
    "core.gating:router_init(key)": _KEY,
    "core.gating:route(key)": _KEY + " (route(generator=))",
    "models.api:init_params(key)": _KEY,
    "models.attention:attn_init(key)": _KEY,
    "models.layers:dense_init(key)": _KEY,
    "models.layers:embed_init(key)": _KEY,
    "models.mamba2:mamba2_init(key)": _KEY,
    "models.mlp:ffn_init(key)": _KEY,
    "models.moe:moe_init(key)": _KEY,
    "models.transformer:init_lm(key)": _KEY,
    "models.whisper:init_encdec(key)": _KEY,
}


def _module_name(rel: str) -> str:
    """'core/autotune.py' -> 'core.autotune'; 'core/__init__.py' -> 'core'."""
    parts = rel[:-3].split("/")
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def _source(rel: str, node: ast.ImportFrom):
    """The dotted package-relative module an import reads, or None when it
    reads from outside the reference package."""
    if node.level:
        pkg = rel.split("/")[:-1]
        base = pkg[:len(pkg) - node.level + 1]
        return ".".join(base + ([node.module] if node.module else []))
    mod = node.module or ""
    if mod == "repro" or mod.startswith("repro."):
        return mod[len("repro."):] if mod != "repro" else ""
    return None


def _is_module(dotted: str) -> bool:
    path = REF.joinpath(*dotted.split(".")) if dotted else REF
    return path.with_suffix(".py").is_file() or path.is_dir()


def _params(fn: ast.FunctionDef):
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    names += [f"*{a.vararg.arg}"] if a.vararg else []
    names += [f"**{a.kwarg.arg}"] if a.kwarg else []
    return [n for n in names if n not in ("self", "cls")]


def _fields(cls: ast.ClassDef):
    """A dataclass's or NamedTuple's fields, else None."""
    def named(e):
        e = e.func if isinstance(e, ast.Call) else e
        return getattr(e, "id", getattr(e, "attr", None))
    if not ({"dataclass"} & {named(d) for d in cls.decorator_list}
            or "NamedTuple" in {named(b) for b in cls.bases}):
        return None
    return [b.target.id for b in cls.body if isinstance(b, ast.AnnAssign)
            and isinstance(b.target, ast.Name)]


def _bound_names(targets):
    """The names an assignment binds (not ``os.environ[...] = ...``)."""
    for t in targets:
        if isinstance(t, ast.Name):
            yield t.id
        elif isinstance(t, (ast.Tuple, ast.List)):
            yield from _bound_names(t.elts)
        elif isinstance(t, ast.Starred):
            yield from _bound_names([t.value])


def _public(name):
    return not name.startswith("_")


@functools.lru_cache(maxsize=None)
def surface(rel: str):
    """The reference file's entries: key -> (names to look up, param or
    None, kind), kind 'module' or 'object' for a name, None otherwise."""
    mod = _module_name(rel)
    init = rel.endswith("__init__.py")
    out = {}

    def add(names, param=None, kind=None):
        key = f"{mod}:{'.'.join(names)}" + (f"({param})" if param else "")
        out[key] = (tuple(names), param, kind)

    def body(nodes):
        for node in nodes:
            if isinstance(node, (ast.If, ast.Try)):
                body(node.body)
                body(getattr(node, "orelse", []))
            elif isinstance(node, ast.FunctionDef) and _public(node.name):
                add([node.name], kind="object")
                for p in _params(node):
                    add([node.name], p)
            elif isinstance(node, ast.ClassDef) and _public(node.name):
                add([node.name], kind="object")
                ctor = _fields(node)
                for b in node.body:
                    if not isinstance(b, ast.FunctionDef):
                        continue
                    if b.name == "__init__":
                        ctor = _params(b)
                    elif _public(b.name):
                        add([node.name, b.name])
                        for p in _params(b):
                            add([node.name, b.name], p)
                for p in ctor or ():
                    add([node.name], p)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for n in _bound_names(targets):
                    if _public(n):
                        add([n], kind="object")
            elif isinstance(node, ast.ImportFrom):
                src = _source(rel, node)
                if src is None:
                    continue
                for alias in node.names:
                    name = alias.asname or alias.name
                    sub = f"{src}.{alias.name}" if src else alias.name
                    is_mod = _is_module(sub)
                    if _public(name) and (init or not is_mod):
                        add([name], kind="module" if is_mod else "object")
    body(ast.parse((REF / rel).read_text()).body)
    return out


@functools.lru_cache(maxsize=None)
def _all_entries():
    out = {}
    for rel in FILES:
        out.update((k, (rel, v)) for k, v in surface(rel).items())
    return out


def _port_module(rel: str):
    mod = _module_name(rel)
    return importlib.import_module("repro_torch" + (f".{mod}" if mod else ""))


def _param_name(p: inspect.Parameter) -> str:
    return {p.VAR_POSITIONAL: f"*{p.name}",
            p.VAR_KEYWORD: f"**{p.name}"}.get(p.kind, p.name)


def port_has(module, entry) -> bool:
    names, param, kind = entry
    obj = module
    for n in names:
        if not hasattr(obj, n):
            return False
        obj = getattr(obj, n)
    if param is not None:
        try:
            sig = inspect.signature(obj)
        except (TypeError, ValueError):
            return False
        return param in {_param_name(p) for p in sig.parameters.values()}
    if kind is not None:
        return inspect.ismodule(obj) == (kind == "module")
    return True


def stated(key: str) -> bool:
    """``key`` or the name it belongs to (a method's class, a parameter's
    function) stands in STATED."""
    mod, _, rest = key.partition(":")
    names = rest.split("(")[0].split(".")
    return key in STATED or any(
        f"{mod}:{'.'.join(names[:i])}" in STATED
        for i in range(1, len(names) + 1))


@pytest.mark.parametrize("rel", FILES)
def test_every_reference_name_has_a_counterpart(rel):
    module = _port_module(rel)
    missing = [key for key, entry in surface(rel).items()
               if not stated(key) and not port_has(module, entry)]
    assert not missing, (f"src/repro/{rel}: no counterpart in the port and "
                         f"not in STATED: {missing}")


@pytest.mark.parametrize("key", sorted(STATED))
def test_stated_entry_names_a_live_difference(key):
    entries = _all_entries()
    assert key in entries, f"{key} names nothing in the reference"
    rel, entry = entries[key]
    assert not port_has(_port_module(rel), entry), \
        f"the port now has {key}: take it out of STATED"
    assert STATED[key].strip(), f"{key} has no reason"
