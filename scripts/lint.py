#!/usr/bin/env python
"""Lint gate for scripts/ci.sh.

Runs ``ruff check`` (configured in pyproject.toml) when ruff is
installed.  This container does not ship ruff and nothing may be pip
installed, so a minimal in-repo fallback enforces the mechanical subset
of the same config — syntax, unused imports (F401), line length (E501,
100 cols), tabs and trailing whitespace — on the same file set.  CI
(ubuntu runners, see .github/workflows/ci.yml) installs ruff and gets
the full rule set; the fallback keeps the gate meaningful locally.

Independent of ruff, the **span-registry check** always runs: every
``span("...")`` / ``mark("...")`` string literal in ``src/`` and
``benchmarks/`` must appear in its package's ``SPAN_NAMES`` /
``MARK_NAMES`` (parsed by AST, no import): ``src/repro_torch/`` in
``repro_torch.obs.trace``'s, everything else in ``repro.obs.trace``'s.
Readers find spans by those exact strings (``check_bench.py``'s gates, a
profile's device time by span), so an unregistered name silently drops
out of them, not a style nit.
"""

from __future__ import annotations

import ast
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
TARGETS = ["src", "benchmarks", "scripts", "tests"]
LINE_LENGTH = 100


def _pinned_ruff() -> str | None:
    """The ruff pin from pyproject's ``[project.optional-dependencies]``
    lint extra (e.g. ``"0.8.4"``) — the single source of truth CI installs."""
    try:
        import tomllib

        with open(ROOT / "pyproject.toml", "rb") as f:
            deps = tomllib.load(f)["project"]["optional-dependencies"]["lint"]
        for d in deps:
            if d.startswith("ruff=="):
                return d.split("==", 1)[1]
    except Exception:
        pass
    return None


def _ruff() -> int | None:
    exe = shutil.which("ruff")
    cmd = [exe] if exe else None
    if cmd is None:
        probe = subprocess.run(
            [sys.executable, "-m", "ruff", "--version"], capture_output=True
        )
        if probe.returncode == 0:
            cmd = [sys.executable, "-m", "ruff"]
    if cmd is None:
        return None
    pin = _pinned_ruff()
    if pin is not None:
        ver = subprocess.run(cmd + ["--version"], capture_output=True, text=True)
        got = (ver.stdout or "").strip().split()[-1] if ver.returncode == 0 else ""
        if got and got != pin:
            print(
                f"lint: WARNING local ruff {got} != pinned {pin} "
                "(pyproject [lint]); results may differ from CI"
            )
    return subprocess.run(cmd + ["check"] + TARGETS, cwd=ROOT).returncode


class _ImportCollector(ast.NodeVisitor):
    def __init__(self) -> None:
        self.imported: dict[str, int] = {}  # bound name -> lineno
        self.used: set[str] = set()

    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            name = a.asname or a.name.split(".")[0]
            self.imported.setdefault(name, node.lineno)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module == "__future__":
            return  # __future__ imports are directives, never "unused"
        for a in node.names:
            if a.name == "*":
                continue
            self.imported.setdefault(a.asname or a.name, node.lineno)

    def visit_Name(self, node: ast.Name) -> None:
        if isinstance(node.ctx, ast.Load):
            self.used.add(node.id)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        self.generic_visit(node)


def _noqa_lines(src: str) -> set[int]:
    return {
        i for i, line in enumerate(src.splitlines(), 1) if "# noqa" in line
    }


def _check_file(path: pathlib.Path) -> list[str]:
    rel = path.relative_to(ROOT)
    src = path.read_text()
    problems: list[str] = []
    try:
        tree = ast.parse(src, filename=str(rel))
    except SyntaxError as e:
        return [f"{rel}:{e.lineno}: E999 syntax error: {e.msg}"]
    noqa = _noqa_lines(src)
    coll = _ImportCollector()
    coll.visit(tree)
    # names used in docstring-level __all__ count as used
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            coll.used.add(node.value)
    for name, lineno in coll.imported.items():
        if name not in coll.used and lineno not in noqa:
            problems.append(f"{rel}:{lineno}: F401 unused import {name!r}")
    for i, line in enumerate(src.splitlines(), 1):
        if i in noqa:
            continue
        if len(line) > LINE_LENGTH:
            problems.append(f"{rel}:{i}: E501 line too long ({len(line)} > {LINE_LENGTH})")
        if "\t" in line:
            problems.append(f"{rel}:{i}: W191 tab in indentation/content")
        if line != line.rstrip():
            problems.append(f"{rel}:{i}: W291 trailing whitespace")
    return problems


# ---------------------------------------------------------------------------
# Span-name registry check (runs in BOTH the ruff and fallback paths)
# ---------------------------------------------------------------------------

TRACE_MODULE = ROOT / "src" / "repro" / "obs" / "trace.py"
#: the port's registry, for the files under ``src/repro_torch/``
PORT_TRACE_MODULE = ROOT / "src" / "repro_torch" / "obs" / "trace.py"
#: the file sets the registry check scans: instrumented production code.
#: tests are exempt — they exercise the tracer with throwaway names.
SPAN_CHECK_TARGETS = ["src", "benchmarks"]


def _registry_module(rel: pathlib.PurePath) -> pathlib.Path:
    """The ``trace.py`` whose registry governs the file at ``rel`` (relative
    to the root): the port's for the port's package, the JAX package's for
    the rest."""
    return PORT_TRACE_MODULE if rel.parts[:2] == ("src", "repro_torch") else TRACE_MODULE


def _registry_names(var: str, module: pathlib.Path = TRACE_MODULE) -> set[str]:
    """The string members of ``module``'s ``var`` frozenset, read by AST
    (no import: lint must not require jax or the package on sys.path)."""
    tree = ast.parse(module.read_text(), filename=str(module))
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        if not any(isinstance(t, ast.Name) and t.id == var for t in node.targets):
            continue
        out: set[str] = set()
        for c in ast.walk(node.value):
            if isinstance(c, ast.Constant) and isinstance(c.value, str):
                out.add(c.value)
        return out
    raise AssertionError(f"{var} not found in {module}")


def _span_calls(tree: ast.AST) -> list[tuple[int, str, str]]:
    """Every ``span(...)`` / ``mark(...)`` call (bare name or attribute,
    e.g. ``obs_trace.span``) whose first argument is a string literal:
    ``(lineno, func, name)``."""
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        fname = fn.id if isinstance(fn, ast.Name) else (
            fn.attr if isinstance(fn, ast.Attribute) else None
        )
        if fname not in ("span", "mark"):
            continue
        if not node.args:
            continue
        a0 = node.args[0]
        if isinstance(a0, ast.Constant) and isinstance(a0.value, str):
            out.append((node.lineno, fname, a0.value))
    return out


def _span_registry_check() -> int:
    registries = {
        m: {"span": _registry_names("SPAN_NAMES", m), "mark": _registry_names("MARK_NAMES", m)}
        for m in (TRACE_MODULE, PORT_TRACE_MODULE)
    }
    problems: list[str] = []
    for target in SPAN_CHECK_TARGETS:
        for path in sorted((ROOT / target).rglob("*.py")):
            if "artifacts" in path.parts:
                continue
            try:
                tree = ast.parse(path.read_text(), filename=str(path))
            except SyntaxError:
                continue  # the main lint reports syntax errors
            rel = path.relative_to(ROOT)
            module = _registry_module(rel)
            for lineno, fname, name in _span_calls(tree):
                if name not in registries[module][fname]:
                    problems.append(
                        f"{rel}:{lineno}: SPAN001 {fname}({name!r}) not in "
                        f"{module.relative_to(module.parents[3]).as_posix()}'s "
                        f"{'SPAN_NAMES' if fname == 'span' else 'MARK_NAMES'} "
                        "— register the name there first (readers find spans by it)"
                    )
    for p in problems:
        print(p)
    return 1 if problems else 0


def _fallback() -> int:
    problems: list[str] = []
    for target in TARGETS:
        for path in sorted((ROOT / target).rglob("*.py")):
            if "artifacts" in path.parts:
                continue
            problems.extend(_check_file(path))
    for p in problems:
        print(p)
    print(
        f"fallback lint (ruff unavailable): {len(problems)} problem(s) over "
        f"{TARGETS} [F401/E501/W191/W291 + syntax]"
    )
    return 1 if problems else 0


def main() -> int:
    spans = _span_registry_check()  # always runs: ruff cannot check this
    rc = _ruff()
    if rc is None:
        rc = _fallback()
    return rc or spans


if __name__ == "__main__":
    raise SystemExit(main())
