"""The scripts/lint.py span-registry AST check: unregistered
``span("...")`` / ``mark("...")`` literals in instrumented sources are a
lint failure (they silently un-arm the bench gates keyed on span names)."""

import ast
import importlib.util
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[2]


def _lint():
    spec = importlib.util.spec_from_file_location(
        "repro_lint", ROOT / "scripts" / "lint.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_span_calls_finds_name_and_attribute_forms():
    lint = _lint()
    tree = ast.parse(
        "span('a.b')\n"
        "obs_trace.span('c.d', k=1)\n"
        "mark('e')\n"
        "span(name)\n"          # non-literal arg0: skipped
        "other('f')\n"          # not span/mark: skipped
        "span()\n"              # no args: skipped
    )
    calls = lint._span_calls(tree)
    assert [(f, n) for _, f, n in calls] == [
        ("span", "a.b"), ("span", "c.d"), ("mark", "e")
    ]


def test_registry_names_parse_without_import():
    lint = _lint()
    spans = lint._registry_names("SPAN_NAMES")
    marks = lint._registry_names("MARK_NAMES")
    assert "compile_pipeline" in spans and "explain.report" in spans
    assert "serve.submit" in marks
    assert "totally-bogus-span" not in spans


def test_registry_check_passes_on_current_tree():
    lint = _lint()
    assert lint._span_registry_check() == 0


def test_unregistered_name_would_be_flagged(tmp_path, capsys, monkeypatch):
    """Drop a file with an unregistered span literal into a scanned tree:
    the check must fail with a SPAN001 line naming it."""
    lint = _lint()
    src = tmp_path / "src"
    src.mkdir()
    (src / "bad.py").write_text(
        "from repro.obs import span\n\nwith span('not.registered'):\n    pass\n"
    )
    (tmp_path / "benchmarks").mkdir()
    monkeypatch.setattr(lint, "ROOT", tmp_path)
    assert lint._span_registry_check() == 1
    out = capsys.readouterr().out
    assert "SPAN001" in out and "not.registered" in out


def _scan_one(lint, tmp_path, monkeypatch, rel, code):
    """Run the registry check over a root holding one source file at ``rel``."""
    path = tmp_path / rel
    path.parent.mkdir(parents=True)
    path.write_text(code)
    (tmp_path / "benchmarks").mkdir(exist_ok=True)
    monkeypatch.setattr(lint, "ROOT", tmp_path)
    return lint._span_registry_check()


def test_port_names_are_checked_against_the_port_registry(tmp_path, capsys, monkeypatch):
    """A name only the port registers passes under ``src/repro_torch/``."""
    lint = _lint()
    port = lint._registry_names("SPAN_NAMES", lint.PORT_TRACE_MODULE)
    assert "train.optimizer" in port and "attn.bwd" in port
    assert "train.optimizer" not in lint._registry_names("SPAN_NAMES")
    code = "from repro_torch.obs import span\n\nwith span('train.optimizer'):\n    pass\n"
    assert _scan_one(lint, tmp_path, monkeypatch, "src/repro_torch/step.py", code) == 0
    assert "SPAN001" not in capsys.readouterr().out


def test_unregistered_port_name_is_flagged(tmp_path, capsys, monkeypatch):
    lint = _lint()
    code = "from repro_torch.obs import span\n\nwith span('train.not_registered'):\n    pass\n"
    assert _scan_one(lint, tmp_path, monkeypatch, "src/repro_torch/step.py", code) == 1
    out = capsys.readouterr().out
    assert "SPAN001" in out and "train.not_registered" in out
    assert "src/repro_torch/obs/trace.py" in out


def test_port_only_name_is_flagged_in_the_jax_package(tmp_path, capsys, monkeypatch):
    """The JAX package keeps its own registry: a port-only name fails there."""
    lint = _lint()
    code = "from repro.obs import span\n\nwith span('train.optimizer'):\n    pass\n"
    assert _scan_one(lint, tmp_path, monkeypatch, "src/repro/step.py", code) == 1
    out = capsys.readouterr().out
    assert "train.optimizer" in out and "src/repro/obs/trace.py" in out
