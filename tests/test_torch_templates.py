"""The port's template layer (``internals/yaml_loader.py``, ``cli.py``)
against the reference's: the loader builds the port's counterparts of
the reference loader's classes with the same arguments on all four
templates, the loader's variable, module and anchor rules hold, and
``python -m pathway_tpu_torch.cli run <template> --device cpu`` serves the
demo and adaptive templates' routes, as the reference's tests check
(``tests/test_templates.py``).  The multimodal and slides templates'
served runs stay ``slow``, as they are in the reference."""

import io
import json
import os
import subprocess
import sys
import time
import urllib.request

import pytest
import torch

from pathway_tpu import cli as ref_cli
from pathway_tpu.internals import yaml_loader as ref_loader
from pathway_tpu_torch import cli
from pathway_tpu_torch.device import default_device, set_default_device
from pathway_tpu_torch.internals import yaml_loader

from .utils import REPO_ROOT, free_port

TEMPLATES = ["demo_question_answering", "adaptive_rag", "multimodal_rag", "slides_search"]


@pytest.fixture
def on_cpu(monkeypatch):
    """The port's process default on the CPU for one test (what
    ``cli run --device cpu`` sets), restored after."""
    from pathway_tpu_torch import device

    monkeypatch.setattr(device, "_default_device", default_device())
    set_default_device("cpu")
    assert default_device() == "cpu"


def _recorded(loader, monkeypatch, root):
    """Load with every ``!pw.`` node recorded, not built: (target,
    args, kwargs), the target named relative to its package."""

    def resolve(path, _real=loader._resolve_callable):
        target = _real(path)
        name = f"{target.__module__}.{target.__qualname__}"
        assert name.startswith(root + "."), name
        rel = name[len(root) + 1:]

        def record(*args, **kwargs):
            return ("built", rel, args, kwargs)

        return record

    monkeypatch.setattr(loader, "_resolve_callable", resolve)


@pytest.mark.parametrize("name", TEMPLATES)
def test_templates_build_the_reference_loaders_classes_with_the_same_arguments(name, monkeypatch):
    path = os.path.join(REPO_ROOT, "templates", f"{name}.yaml")
    _recorded(ref_loader, monkeypatch, "pathway_tpu")
    _recorded(yaml_loader, monkeypatch, "pathway_tpu_torch")
    with open(path) as f:
        want = ref_loader.load_yaml(f)
    with open(path) as f:
        got = yaml_loader.load_yaml(f)
    assert got == want
    assert got["question_answerer"][0] == "built" and got["port"] == 8000


def _plain(node):
    """A parsed template with its deferred ``!pw.`` nodes as tuples."""
    if isinstance(node, yaml_loader._Deferred):
        return ("!", node.path, node.kind, _plain(node.payload))
    if isinstance(node, dict):
        return {k: _plain(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_plain(v) for v in node]
    return node


@pytest.mark.parametrize("name", ["demo_question_answering", "adaptive_rag"])
def test_chip_smoke_template_spec_equals_the_parsed_template(name):
    """``chip_smoke.py`` serves phase 20 (b) from a Python copy of the
    template where PyYAML is absent: the copy is the parsed file, node for
    node, and builds through the loader's own second pass."""
    import importlib.util

    import yaml

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO_ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    with open(os.path.join(REPO_ROOT, "templates", f"{name}.yaml")) as f:
        parsed = yaml.load(f, Loader=yaml_loader._loader())
    assert _plain(chip_smoke.template_spec(name)) == _plain(parsed)


@pytest.mark.parametrize("name", ["demo_question_answering", "adaptive_rag"])
def test_templates_build_on_the_cpu(name, on_cpu):
    from pathway_tpu_torch.xpacks.llm import question_answering

    import pathway_tpu_torch

    pathway_tpu_torch.reset()
    try:
        with open(os.path.join(REPO_ROOT, "templates", f"{name}.yaml")) as f:
            cfg = yaml_loader.load_yaml(f)
        qa = cfg["question_answerer"]
        assert isinstance(qa, question_answering.BaseRAGQuestionAnswerer)
        assert qa.llm._generator.device == torch.device("cpu")
        assert qa.indexer.embedder._encoder.device == torch.device("cpu")
    finally:
        pathway_tpu_torch.reset()


def test_yaml_loader_variables_inside_constructors(on_cpu):
    cfg = yaml_loader.load_yaml(
        io.StringIO(
            """
$dim: 24
shared: &enc !pw.xpacks.llm.embedders.TpuEmbedder
  dimension: $dim
  n_layers: 1
  max_length: 32
again: *enc
number: $dim
"""
        )
    )
    assert cfg["number"] == 24
    assert cfg["shared"].get_embedding_dimension() == 24
    assert cfg["again"] is cfg["shared"], "anchor must share one instance"


def test_yaml_loader_resolves_nested_modules():
    qa = yaml_loader._resolve_callable("pw.xpacks.llm.question_answering.AdaptiveRAGQuestionAnswerer")
    assert qa.__name__ == "AdaptiveRAGQuestionAnswerer" and qa.__module__.startswith("pathway_tpu_torch.")
    assert yaml_loader._resolve_callable("pw.stdlib.indexing.BruteForceKnnFactory")
    assert yaml_loader._resolve_callable("pathway.io.fs.read").__module__ == "pathway_tpu_torch.io.fs"
    assert yaml_loader._resolve_callable("pathway_tpu_torch.xpacks.llm.prompts.prompt_qa")
    assert yaml_loader._resolve_callable("os.path.join") is os.path.join


def test_yaml_loader_circular_variables_raise():
    with pytest.raises(ValueError, match="circular"):
        yaml_loader.load_yaml(io.StringIO("$a: $b\n$b: $a\nx: $a\n"))


def test_yaml_loader_scalars_sequences_and_shared_variables():
    cfg = yaml_loader.load_yaml(io.StringIO(
        "$p: !pw.xpacks.llm.prompts.prompt_short_qa [q, [d1, d2]]\n"
        "a: $p\nb: [$p, $p]\nc: !pw.xpacks.llm.splitters.TokenCountSplitter {max_tokens: 7}\n"
    ))
    want = ref_loader.load_yaml(io.StringIO(
        "$p: !pw.xpacks.llm.prompts.prompt_short_qa [q, [d1, d2]]\na: $p\nb: [$p, $p]\n"
    ))
    assert cfg["a"] == want["a"] == cfg["b"][0] == cfg["b"][1]
    assert type(cfg["c"]).__module__ == "pathway_tpu_torch.xpacks.llm.splitters"


@pytest.mark.parametrize("tag", ["!pw.pathway_tpu.xpacks.llm.prompts.prompt_qa", "!pw:pathway_tpu.io.fs.read"])
def test_a_tag_naming_the_jax_package_raises(tag):
    with pytest.raises(ValueError, match="pathway_tpu"):
        yaml_loader.load_yaml(io.StringIO(f"x: {tag} {{}}\n"))
    with pytest.raises(ValueError, match="pathway_tpu"):
        yaml_loader._resolve_callable("pathway_tpu.io.fs.read")


def test_load_yaml_without_pyyaml_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)
    monkeypatch.setattr(yaml_loader, "_loader_cls", None)
    with pytest.raises(ImportError, match="PyYAML"):
        yaml_loader.load_yaml(io.StringIO("a: 1\n"))


def test_pw_load_yaml_is_the_loader():
    import pathway_tpu_torch as pw

    assert pw.load_yaml is yaml_loader.load_yaml
    assert pw.load_yaml(io.StringIO("$v: 3\nx: [$v, 4]\n")) == {"x": [3, 4]}


# -- the command line ------------------------------------------------------------------


def test_topology_env_equals_reference():
    for args in ((0, 1, 10000), (1, 4, 23456)):
        assert cli._topology_env(*args, base={"KEEP": "1"}) == ref_cli._topology_env(*args, base={"KEEP": "1"})


def test_spawn_sets_the_topology_for_each_process(tmp_path):
    prog = tmp_path / "show.py"
    prog.write_text(
        "import os, sys\n"
        f"open(os.path.join({str(tmp_path)!r}, 'rank' + os.environ['PATHWAY_PROCESS_ID']), 'w').write(\n"
        "    ','.join(os.environ[k] for k in ('PATHWAY_PROCESSES', 'PATHWAY_FIRST_PORT', "
        "'PATHWAY_COORDINATOR_ADDRESS')))\n"
    )
    port = free_port()
    rc = cli.main(["spawn", "-n", "2", "--first-port", str(port), sys.executable, str(prog)])
    assert rc == 0
    for r in (0, 1):
        assert (tmp_path / f"rank{r}").read_text() == f"2,{port},127.0.0.1:{port}"


def test_spawn_from_env_and_replay(monkeypatch, tmp_path):
    prog = tmp_path / "ok.py"
    prog.write_text("import os; assert os.environ['PATHWAY_PROCESSES'] == '2'\n")
    monkeypatch.setenv("PATHWAY_SPAWN_ARGS", f"-n 2 --first-port {free_port()} {sys.executable}")
    assert cli.main(["spawn-from-env", str(prog)]) == 0
    with pytest.raises(NotImplementedError, match="framework slice 2"):
        cli.main(["replay", sys.executable, str(prog)])


def _post(port, route, payload, timeout):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{route}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _launch(template, port, device="cpu"):
    return subprocess.Popen(
        [sys.executable, "-m", "pathway_tpu_torch.cli", "run", template, "--port", str(port), "--device", device],
        cwd=REPO_ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )


def _wait_up(proc, port, probe, deadline_s=90):
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        if proc.poll() is not None:
            out, _ = proc.communicate()
            raise AssertionError(f"template app died:\n{out[-3000:]}")
        try:
            _post(port, "/v1/retrieve", probe, timeout=5)
            return
        except Exception:
            time.sleep(0.5)
    raise AssertionError("template server did not come up")


def _stop(proc):
    proc.kill()
    proc.wait(timeout=30)


def test_cli_serves_the_demo_template_on_the_cpu():
    """The reference's check of the demo app's five routes
    (tests/test_templates.py:171-199), against the port's command line."""
    port = free_port()
    proc = _launch("templates/demo_question_answering.yaml", port)
    try:
        _wait_up(proc, port, {"query": "cats", "k": 1})
        docs = _post(port, "/v1/retrieve", {"query": "anything", "k": 3}, 60)
        assert len(docs) == 3 and all("text" in d for d in docs)
        assert all("sample_documents" in d["metadata"]["path"] for d in docs)
        stats = _post(port, "/v1/statistics", {}, 60)
        assert stats["file_count"] >= 3, stats
        listed = _post(port, "/v1/pw_list_documents", {}, 60)
        assert {d["path"].rsplit("/", 1)[-1] for d in listed} >= {"animals.txt", "dataflow.txt", "tpu.txt"}
        answer = _post(port, "/v1/pw_ai_answer", {"prompt": "What do cats do?"}, 120)
        assert isinstance(answer, str) and answer.strip()
        summary = _post(port, "/v1/pw_ai_summary", {"text_list": ["cats purr", "dogs bark"]}, 120)
        assert isinstance(summary, str) and summary.strip()
    finally:
        _stop(proc)


def test_cli_serves_the_adaptive_template_on_the_cpu():
    """(reference: tests/test_templates.py:50-110)"""
    port = free_port()
    proc = _launch("templates/adaptive_rag.yaml", port)
    try:
        _wait_up(proc, port, {"query": "cats", "k": 1})
        docs = _post(port, "/v1/retrieve", {"query": "anything", "k": 3}, 60)
        assert len(docs) == 3 and all("text" in d and "metadata" in d for d in docs)
        assert any("sample_documents" in d["metadata"]["path"] for d in docs)
        answer = _post(port, "/v1/pw_ai_answer", {"prompt": "What do cats do?"}, 120)
        assert isinstance(answer, str) and answer.strip(), answer
    finally:
        _stop(proc)


def test_cli_on_cuda_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _launch("templates/demo_question_answering.yaml", free_port(), device="cuda")
    try:
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            _stop(proc)
    assert proc.returncode != 0
    assert "CUDA is not available" in out


@pytest.mark.slow
def test_cli_serves_the_multimodal_template_on_the_cpu():
    """(reference: tests/test_templates.py:202, slow there too)"""
    port = free_port()
    proc = _launch("templates/multimodal_rag.yaml", port)
    try:
        _wait_up(proc, port, {"query": "red", "k": 1}, deadline_s=180)
        docs = _post(port, "/v1/retrieve", {"query": "red square", "k": 3}, 60)
        assert len(docs) == 3 and all(d["text"] for d in docs), docs
        paths = {d["metadata"]["path"].rsplit("/", 1)[-1] for d in docs}
        assert paths == {"red_square.png", "blue_circle.png", "green_stripes.png"}, paths
        answer = _post(port, "/v1/pw_ai_answer", {"prompt": "Which image shows a red square?"}, 180)
        assert isinstance(answer, str) and answer.strip()
    finally:
        _stop(proc)


@pytest.mark.slow
def test_cli_serves_the_slides_template_on_the_cpu():
    """(reference: tests/test_templates.py:228, slow there too)"""
    port = free_port()
    proc = _launch("templates/slides_search.yaml", port)
    try:
        _wait_up(proc, port, {"query": "revenue", "k": 1}, deadline_s=180)
        slides = _post(port, "/v1/pw_ai_answer", {"prompt": "revenue growth"}, 120)
        assert isinstance(slides, list) and slides, slides
        assert all("text" in s and "metadata" in s for s in slides)
        assert all("slide" in s["metadata"] for s in slides), slides
        # three slides indexed from one deck
        stats = _post(port, "/v1/statistics", {}, 60)
        assert stats["file_count"] == 3, stats
    finally:
        _stop(proc)
