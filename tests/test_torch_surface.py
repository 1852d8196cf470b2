"""The port's public surface held against the reference's, by AST.

Both packages are parsed, not imported (no JAX needed).  Every module of
``pathway_tpu/`` must have a module at the same path in
``pathway_tpu_torch/``, and in it a counterpart of each public name of
the reference's module (a top-level function or class whose name does
not start with ``_``), each public method of a public class (with
``__init__`` and ``__call__``), each parameter name of those functions
and methods, and each ``__all__`` entry.

A counterpart of a name is any top-level binding of it in the port's
module (``def``, ``class``, an assignment or an import), or a module
``__getattr__`` that answers it.  A method may come from a base class
defined in the port, and ``__call__`` from ``torch.nn.Module``, whose
``__call__`` runs ``forward`` (so its parameters are ``forward``'s).  A
parameter is compared by name only, ``self`` / ``cls`` and ``*args`` /
``**kwargs`` left out.

What the port does not carry sits in ``EXCEPTIONS``, one reviewed entry
per gap, each with its reason.  Keys:

- ``"models/_params.py"``: a module;
- ``"ops/maxsim.py::build_maxsim_kernel"``: a public name;
- ``"models/hf_import.py::BertEncoderModule.apply"``: a method;
- ``"models/encoder.py::SentenceEncoder.__init__(model)"``: a parameter;
- ``"parallel/mesh.py::__all__[shard_rows]"``: an ``__all__`` entry.

A name excepted for the port also excepts its ``__all__`` entries in the
same module, and a module excepted excepts everything in it.  An entry
that no longer matches a gap fails the gate too, so the table stays
true.  To add one: run this file, read the gap it reports, and add the
key with a one-line reason (JAX-only, a Flax twin and its port, a
changed calling convention) after checking that no counterpart is due.
"""

from __future__ import annotations

import ast
import time
from pathlib import Path
from typing import Dict, List, Optional, Set

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "pathway_tpu"
PORT = ROOT / "pathway_tpu_torch"

_JAX_SHARDING = "JAX-only: a NamedSharding helper; the port places blocks on a Mesh's devices"
_MOSAIC = "JAX-only: makes a Mosaic-era Pallas kernel; the port's MaxSim runs as torch ops"
_JIT_SCAN = "JAX-only: finds jax.jit callables; the port's analysis has no jit"
_DONATION = "JAX-only: buffer donation; the port's guard stamps in-place writes instead"

EXCEPTIONS: Dict[str, str] = {
    # modules
    "models/_params.py": "JAX-only: Flax param-tree boxing; the port's bridge is models/params.py",
    "observe/_state.py": "JAX-only: the reference's enabled flag module; the port keeps it in observe/histogram.py",
    "ops/ivf_pallas.py": "the Pallas rescore kernel; ported as csrc/ivf_rescore.cu behind ops/ivf_rescore.py",
    # analysis: jit and donation scans
    "analysis/registry.py::collect_jit_names": _JIT_SCAN,
    "analysis/registry.py::collect_donating_jits": _JIT_SCAN,
    "analysis/registry.py::scope_jit_and_device_vars": _JIT_SCAN,
    "analysis/registry.py::is_jit_call": _JIT_SCAN,
    "analysis/registry.py::is_device_value_arg(jit_fns)": (
        "the port passes its dispatching callables as fns, not jitted ones"
    ),
    "analysis/residency.py::__all__[DONATED]": _DONATION,
    "analysis/residency.py::__all__[DONATION_SITES]": _DONATION,
    # serve and host surfaces
    "cache/result.py::ResultCache.observe_metrics": (
        "an empty delegate; the port never registers a ResultCache as a provider"
    ),
    "io/http/__init__.py::PathwayWebserver.loop": (
        "the reference's aiohttp event loop; the port serves on http.server threads"
    ),
    "xpacks/llm/llms.py::HFPipelineChat.crop_to_max_context_size": (
        "the port's HFPipelineChat raises at construction (no transformers runtime)"
    ),
    # models: Flax modules become torch modules
    "models/clip.py::ClipModel.__init__(model)": (
        "a Flax module instance; the port builds its torch module from the config"
    ),
    "models/cross_encoder.py::CrossEncoderModel.__init__(model)": (
        "a Flax module instance; the port builds its torch module from the config"
    ),
    "models/encoder.py::SentenceEncoder.__init__(model)": (
        "a Flax module instance; the port builds its torch module from the config"
    ),
    "models/hf_import.py::bert_forward(params)": "a param tree becomes the torch trunk (trunk)",
    "models/hf_import.py::bert_forward(cfg)": "the config rides on the torch trunk",
    "models/hf_import.py::bert_classify(params)": "a param tree becomes the torch module (module)",
    "models/hf_import.py::bert_classify(cfg)": "the config rides on the torch module",
    "models/hf_import.py::BertEncoderModule.apply": "Flax apply(variables, ...); the port's module runs forward",
    "models/hf_import.py::BertCrossEncoderModule.apply": "Flax apply(variables, ...); the port's module runs forward",
    "models/transformer.py::KVSelfAttention": (
        "the Flax twin of SelfAttention with a K/V cache; its port is _kv_attention"
    ),
    "models/transformer.py::KVEncoderBlock": "the Flax twin of EncoderBlock with a K/V cache; its port is kv_forward",
    "models/transformer.py::SlotSelfAttention": (
        "the Flax twin of the slot-pool attention; its port is SlotKVDecoder's forward"
    ),
    "models/transformer.py::SlotEncoderBlock": (
        "the Flax twin of the slot-pool block; its port is SlotKVDecoder's forward"
    ),
    "ops/kv_quant.py::kv_pool_scales(params)": "a param tree becomes state, n_layers, n_heads",
    "ops/kv_quant.py::kv_pool_scales(config)": "a param tree becomes state, n_layers, n_heads",
    # ops and parallel
    "ops/donation_guard.py::donating_jit": _DONATION,
    "ops/donation_guard.py::poison": _DONATION,
    "ops/donation_guard.py::wrap": _DONATION,
    "ops/maxsim.py::build_maxsim_kernel": _MOSAIC,
    "ops/maxsim.py::build_maxsim_table_kernel": _MOSAIC,
    "ops/maxsim.py::build_table_merge_kernel": _MOSAIC,
    "ops/topk.py::sharded_topk(matrix)": "a row-sharded jax array becomes the per-device blocks (blocks)",
    "ops/topk.py::sharded_topk(valid)": "a row-sharded jax array becomes the per-device blocks (valids)",
    "parallel/mesh.py::shard_rows": _JAX_SHARDING,
    "parallel/mesh.py::shard_cols": _JAX_SHARDING,
    "parallel/mesh.py::replicated": _JAX_SHARDING,
    "parallel/mesh.py::host_to_global(spec)": "JAX-only: a PartitionSpec; the port takes rows=True|False",
    "parallel/mesh.py::global_zeros(spec)": "JAX-only: a PartitionSpec; the port takes rows=True|False",
    "ops/ring_attention.py::ring_attention": (
        "the per-device shard_map body; the port's ring across ranks is ring_attention_sharded"
    ),
    "parallel/__init__.py::__all__[shard_rows]": _JAX_SHARDING,
    "parallel/__init__.py::__all__[shard_cols]": _JAX_SHARDING,
    "parallel/__init__.py::__all__[replicated]": _JAX_SHARDING,
}

# methods a port class gets from a base outside the package
_EXTERNAL_BASE_METHODS = {"nn.Module": ("__call__",), "torch.nn.Module": ("__call__",), "Module": ("__call__",)}


def _params(fn: ast.AST) -> List[str]:
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs if x.arg not in ("self", "cls")]


def _base_name(node: ast.expr) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        inner = _base_name(node.value)
        return f"{inner}.{node.attr}" if inner else node.attr
    return None


def _module_surface(tree: ast.Module) -> dict:
    """Top-level bindings, public defs with their parameters, classes
    with their methods and bases, ``__all__`` and the names a module
    ``__getattr__`` answers."""
    bound: Set[str] = set()
    funcs: Dict[str, List[str]] = {}
    classes: Dict[str, dict] = {}
    all_: Optional[List[str]] = None
    lazy: Set[str] = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            bound.add(node.name)
            funcs[node.name] = _params(node)
            if node.name == "__getattr__":
                lazy |= {c.value for c in ast.walk(node) if isinstance(c, ast.Constant) and isinstance(c.value, str)}
        elif isinstance(node, ast.ClassDef):
            bound.add(node.name)
            methods: Dict[str, Optional[List[str]]] = {}
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    methods[sub.name] = _params(sub)
                elif isinstance(sub, ast.Assign):
                    methods.update({t.id: None for t in sub.targets if isinstance(t, ast.Name)})
                elif isinstance(sub, ast.AnnAssign) and isinstance(sub.target, ast.Name):
                    methods[sub.target.id] = None
            classes[node.name] = {"methods": methods, "bases": [b for b in map(_base_name, node.bases) if b]}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        bound.add(n.id)
                        if n.id == "__all__" and node.value is not None:
                            try:
                                all_ = [str(x) for x in ast.literal_eval(node.value)]
                            except ValueError:
                                pass
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            bound |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return {"bound": bound, "funcs": funcs, "classes": classes, "all": all_, "lazy": lazy}


def package_surface(root: Path) -> Dict[str, dict]:
    out = {}
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        if rel.startswith("_build/") or "/_build/" in rel:
            continue
        out[rel] = _module_surface(ast.parse(path.read_text(), filename=str(path)))
    return out


_FORWARD = "forward"  # marks a __call__ that nn.Module routes to forward


def _collect_methods(surface: Dict[str, dict], rel: str, name: str, seen: Set) -> Dict[str, object]:
    if (rel, name) in seen:
        return {}
    seen.add((rel, name))
    cls = surface[rel]["classes"][name]
    methods: Dict[str, object] = {}
    for base in cls["bases"]:
        leaf = base.rsplit(".", 1)[-1]
        where = rel if leaf in surface[rel]["classes"] else None
        if where is None:
            owners = [m for m, s in surface.items() if leaf in s["classes"]]
            where = owners[0] if len(owners) == 1 else None
        if where is not None:
            for m, p in _collect_methods(surface, where, leaf, seen).items():
                methods.setdefault(m, p)
        for m in _EXTERNAL_BASE_METHODS.get(base, ()):
            methods.setdefault(m, _FORWARD)
    methods.update(cls["methods"])
    return methods


def _class_methods(surface: Dict[str, dict], rel: str, name: str) -> Dict[str, Optional[List[str]]]:
    """The methods of class ``name`` of module ``rel``, with those of its
    bases: a base of the same module, else the one class of that name in
    the package, else a known external base.  A ``__call__`` that
    ``nn.Module`` gives takes the parameters of the class's ``forward``."""
    methods = _collect_methods(surface, rel, name, set())
    if methods.get("__call__") == _FORWARD:
        methods["__call__"] = methods.get("forward")
    return methods  # type: ignore[return-value]


def surface_gaps(ref: Dict[str, dict], port: Dict[str, dict]) -> List[str]:
    """Every key (in ``EXCEPTIONS``' form) of the reference's surface
    that the port lacks."""
    gaps: List[str] = []

    def missing_params(key: str, want: List[str], have: Optional[List[str]]) -> None:
        if have is not None:
            gaps.extend(f"{key}({p})" for p in want if p not in have)

    for rel, mod in ref.items():
        if rel not in port:
            gaps.append(rel)
            continue
        pm = port[rel]
        for name, params in mod["funcs"].items():
            if name.startswith("_"):
                continue
            if name not in pm["bound"] and name not in pm["lazy"]:
                gaps.append(f"{rel}::{name}")
            elif name in pm["funcs"]:
                missing_params(f"{rel}::{name}", params, pm["funcs"][name])
        for name, cls in mod["classes"].items():
            if name.startswith("_"):
                continue
            if name not in pm["bound"] and name not in pm["lazy"]:
                gaps.append(f"{rel}::{name}")
                continue
            if name not in pm["classes"]:
                continue
            have = _class_methods(port, rel, name)
            for meth, params in cls["methods"].items():
                if params is None or (meth.startswith("_") and meth not in ("__init__", "__call__")):
                    continue
                key = f"{rel}::{name}.{meth}"
                if meth not in have:
                    gaps.append(key)
                else:
                    missing_params(key, params, have[meth])
        for entry in mod["all"] or ():
            if entry not in (pm["all"] or ()):
                gaps.append(f"{rel}::__all__[{entry}]")
    return gaps


def _excepted(gap: str, exceptions: Dict[str, str]) -> bool:
    if gap in exceptions:
        return True
    rel, _, rest = gap.partition("::")
    if rel in exceptions:
        return True
    if rest.startswith("__all__["):
        return f"{rel}::{rest[len('__all__['):-1]}" in exceptions
    return False


def check_surface(ref_root: Path, port_root: Path, exceptions: Dict[str, str]):
    """``(gaps not excepted, exceptions that match no gap)``."""
    gaps = surface_gaps(package_surface(ref_root), package_surface(port_root))
    open_gaps = [g for g in gaps if not _excepted(g, exceptions)]
    used = set(gaps) | {g.partition("::")[0] for g in gaps}
    used |= {f"{g.partition('::')[0]}::{g.partition('::')[2][len('__all__['):-1]}" for g in gaps if "::__all__[" in g}
    stale = sorted(k for k in exceptions if k not in used)
    return open_gaps, stale


# -- the gate ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def surfaces():
    t0 = time.perf_counter()
    out = package_surface(REF), package_surface(PORT)
    return out, time.perf_counter() - t0


def test_every_exception_has_a_reason():
    for key, reason in EXCEPTIONS.items():
        assert isinstance(reason, str) and len(reason.split()) >= 3, key


def test_the_port_carries_every_module_name_method_and_parameter_of_the_reference(surfaces):
    (ref, port), seconds = surfaces
    gaps = [g for g in surface_gaps(ref, port) if not _excepted(g, EXCEPTIONS)]
    assert gaps == [], "the port lacks these names of the reference (port them, or add a reviewed exception):\n" + (
        "\n".join(gaps)
    )
    assert seconds < 10.0


def test_no_exception_outlives_its_gap():
    _gaps, stale = check_surface(REF, PORT, EXCEPTIONS)
    assert stale == [], f"exceptions that match no gap any more (remove them): {stale}"


def test_the_names_this_surface_slice_added_resolve_at_runtime():
    """The AST finds a binding; the package-level names also import."""
    import pathway_tpu_torch.models as models
    import pathway_tpu_torch.observe as observe
    import pathway_tpu_torch.ops as ops
    import pathway_tpu_torch.parallel as parallel

    for mod in (ops, models, parallel, observe):
        for name in mod.__all__:
            assert getattr(mod, name) is not None, (mod.__name__, name)


# -- the gate's self-test: a synthetic pair that drops one name of each kind -------------

_REF_SRC = '''
__all__ = ["f", "C", "g"]

def f(a, b, *, c=1):
    pass

def g():
    pass

class C:
    def __init__(self, x):
        pass

    def m(self, y):
        pass

def _private():
    pass
'''

_DROPS = {
    "module": (None, "mod.py"),
    "function": (_REF_SRC.replace("def g():\n    pass\n", ""), "mod.py::g"),
    "class": (_REF_SRC.replace("class C:", "class D:"), "mod.py::C"),
    "method": (_REF_SRC.replace("def m(self, y)", "def n(self, y)"), "mod.py::C.m"),
    "parameter": (_REF_SRC.replace("def f(a, b, *, c=1)", "def f(a, *, c=1)"), "mod.py::f(b)"),
    "keyword parameter": (_REF_SRC.replace("def f(a, b, *, c=1)", "def f(a, b)"), "mod.py::f(c)"),
    "__all__ entry": (_REF_SRC.replace('"f", "C", "g"', '"f", "C"'), "mod.py::__all__[g]"),
}


def _pair(tmp_path: Path, port_src: Optional[str]):
    ref, port = tmp_path / "ref", tmp_path / "port"
    ref.mkdir()
    port.mkdir()
    (ref / "mod.py").write_text(_REF_SRC)
    if port_src is not None:
        (port / "mod.py").write_text(port_src)
    return ref, port


@pytest.mark.parametrize("kind", list(_DROPS))
def test_the_gate_catches_a_dropped_name(tmp_path, kind):
    port_src, gap = _DROPS[kind]
    ref, port = _pair(tmp_path, port_src)
    assert check_surface(ref, port, {}) == ([gap], [])
    # a reviewed exception closes exactly that gap, and goes stale once the name is back
    assert check_surface(ref, port, {gap: "a synthetic gap of the self-test"}) == ([], [])
    (port / "mod.py").write_text(_REF_SRC)
    assert check_surface(ref, port, {gap: "a synthetic gap of the self-test"}) == ([], [gap])


def test_the_gate_accepts_bases_lazy_names_and_torch_call(tmp_path):
    """A method inherited from a base of the port, a name answered by a
    module ``__getattr__``, and ``__call__`` from ``nn.Module`` count."""
    ref = tmp_path / "ref"
    port = tmp_path / "port"
    ref.mkdir()
    port.mkdir()
    (ref / "mod.py").write_text(
        "class A:\n    def __init__(self, cfg):\n        pass\n\n    def __call__(self, x):\n        pass\n\n"
        "class Loader:\n    pass\n"
    )
    (port / "mod.py").write_text(
        "from torch import nn\n\nclass _Base(nn.Module):\n    def __init__(self, cfg):\n        pass\n\n"
        "class A(_Base):\n    def forward(self, x):\n        pass\n\n"
        "def __getattr__(name):\n    if name == 'Loader':\n        return object\n    raise AttributeError(name)\n"
    )
    assert check_surface(ref, port, {}) == ([], [])
