"""YAML template config loader of the port (counterpart of
``pathway_tpu/internals/yaml_loader.py``; reference: python/pathway/
internals/yaml_loader.py:74-218 — ``$variables`` and ``!pw.<path>`` tags
instantiating python objects, used by RAG app templates; see
``templates/``).

Construction is two-pass: the YAML is first parsed into plain data with
``!pw.`` tags held as deferred nodes, then ``$variables`` are substituted,
then objects instantiate bottom-up — so variables work inside constructor
arguments, and anchors (&x / *x) share ONE constructed object.

``!pw.<path>``, ``!pathway.<path>`` and a bare module path resolve in
``pathway_tpu_torch``; a tag naming ``pathway_tpu`` raises, since the
port never imports the JAX package.  PyYAML is imported by ``load_yaml``
itself: without it, ``load_yaml`` raises ``ImportError``."""

from __future__ import annotations

import importlib
import types
from typing import IO, Any, Dict, Union

__all__ = ["load_yaml", "build_template", "PathwayYamlLoader"]

_ROOTS = ("pw", "pathway", "pathway_tpu_torch")
_loader_cls = None


def _refuse_reference(path: str) -> None:
    if path.split(".")[0] == "pathway_tpu":
        raise ValueError(
            f"template tag !{path} names the JAX package; the port resolves "
            "!pw.<path> in pathway_tpu_torch and never imports pathway_tpu"
        )


def _resolve_callable(path: str) -> Any:
    """Resolve a dotted path like ``pw.xpacks.llm.embedders.TpuEmbedder``."""
    _refuse_reference(path)
    parts = path.split(".")
    if parts[0] in _ROOTS:
        module_name = "pathway_tpu_torch"
    else:
        module_name = parts[0]
    obj = importlib.import_module(module_name)
    for part in parts[1:]:
        if hasattr(obj, part):
            obj = getattr(obj, part)
        elif isinstance(obj, types.ModuleType):
            # walk into a submodule not imported by the parent package
            obj = importlib.import_module(obj.__name__ + "." + part)
        else:
            raise AttributeError(f"{obj!r} has no attribute {part!r} in {path}")
    return obj


class _Deferred:
    """A ``!pw.<path>`` node awaiting variable substitution before
    instantiation."""

    __slots__ = ("path", "kind", "payload")

    def __init__(self, path: str, kind: str, payload: Any):
        self.path = path
        self.kind = kind
        self.payload = payload


def _loader():
    """The PyYAML loader class with the ``!pw.`` constructors, made at
    first use (PyYAML is imported here, not at module import)."""
    global _loader_cls
    if _loader_cls is not None:
        return _loader_cls
    try:
        import yaml
    except ImportError as exc:
        raise ImportError(
            "pw.load_yaml needs PyYAML (the `yaml` module), which is not installed"
        ) from exc

    class PathwayYamlLoader(yaml.SafeLoader):
        pass

    def construct(loader, tag_suffix: str, node):
        # the registered "!pw." prefix is stripped by yaml before we see the
        # suffix, so "xpacks.llm..." is relative to the port unless the user
        # spelled a full module root themselves
        _refuse_reference(tag_suffix)
        if tag_suffix.split(".")[0] not in _ROOTS:
            tag_suffix = "pw." + tag_suffix
        if isinstance(node, yaml.MappingNode):
            return _Deferred(tag_suffix, "map", loader.construct_mapping(node, deep=True))
        if isinstance(node, yaml.SequenceNode):
            return _Deferred(tag_suffix, "seq", loader.construct_sequence(node, deep=True))
        return _Deferred(tag_suffix, "scalar", loader.construct_scalar(node))

    yaml.add_multi_constructor("!pw.", construct, Loader=PathwayYamlLoader)
    yaml.add_multi_constructor("!pw:", construct, Loader=PathwayYamlLoader)
    _loader_cls = PathwayYamlLoader
    return _loader_cls


def __getattr__(name: str):
    if name == "PathwayYamlLoader":
        return _loader()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _instantiate(
    obj: Any,
    variables: Dict[str, Any],
    memo: Dict[int, Any],
    _visiting: tuple = (),
) -> Any:
    """Bottom-up: substitute $variables, then build deferred objects.  The
    memo keeps anchored (&x / *x) deferred nodes single-instance."""
    if isinstance(obj, _Deferred):
        if id(obj) in memo:
            return memo[id(obj)]
        target = _resolve_callable(obj.path)
        payload = _instantiate(obj.payload, variables, memo, _visiting)
        if obj.kind == "map":
            result = target(**payload)
        elif obj.kind == "seq":
            result = target(*payload)
        elif payload in (None, ""):
            result = target() if callable(target) else target
        else:
            result = target(payload)
        memo[id(obj)] = result
        return result
    if isinstance(obj, dict):
        return {k: _instantiate(v, variables, memo, _visiting) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_instantiate(v, variables, memo, _visiting) for v in obj]
    if isinstance(obj, str) and obj.startswith("$"):
        name = obj[1:]
        if name in variables:
            if name in _visiting:
                chain = " -> ".join((*_visiting, name))
                raise ValueError(f"circular $variable reference in template: {chain}")
            # a variable may itself be (or contain) a deferred object; the
            # memo keeps it single-instance across references
            return _instantiate(variables[name], variables, memo, (*_visiting, name))
    return obj


def build_template(data: Any) -> Any:
    """The second pass of ``load_yaml`` over parsed data (``!pw.`` nodes
    deferred): top-level ``$name: value`` entries define variables
    referenced as ``$name`` anywhere — including inside ``!pw.``
    constructor arguments — then the objects are built bottom-up."""
    if not isinstance(data, dict):
        return _instantiate(data, {}, {})
    variables = {k[1:]: v for k, v in data.items() if isinstance(k, str) and k.startswith("$")}
    memo: Dict[int, Any] = {}
    data = {k: v for k, v in data.items() if not (isinstance(k, str) and k.startswith("$"))}
    return _instantiate(data, variables, memo)


def load_yaml(stream: Union[str, IO]) -> Any:
    """Load a template config: parse it, then ``build_template``."""
    loader = _loader()  # raises ImportError without PyYAML
    import yaml

    return build_template(yaml.load(stream, Loader=loader))
