#!/usr/bin/env python
"""In-tree lint gate — the *enforced* analogue of the reference's
clang-tidy policy (reference .clang-tidy:2 `WarningsAsErrors: '*'`).

The image ships no external linter (ruff/flake8 are not installed;
installs are forbidden), so this implements the subset of the
[tool.ruff] policy in pyproject.toml that matters most and that an AST
walk can enforce reliably:

* syntax errors (py_compile),
* unused imports (F401) — module and from-imports, `_`-prefixed exempt,
* star imports (F403),
* duplicate function/class definitions in one scope (F811-lite),
* trailing whitespace and tabs in indentation (W291/W191),
* mutable default arguments (B006).

Run: ``python tools/lint.py`` (exit 1 on any finding).  Wired into
``make lint``, ``make test`` and ``tests/test_lint.py`` so the suite
fails loudly — a written-but-never-run lint config enforces nothing.
"""
from __future__ import annotations

import ast
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

TARGETS = ["rtow_tpu", "tests", "tools", "bench.py", "__graft_entry__.py",
           "chip_smoke.py"]


def iter_files():
    for t in TARGETS:
        path = os.path.join(ROOT, t)
        if os.path.isfile(path):
            yield path
        else:
            for dirpath, dirnames, filenames in os.walk(path):
                dirnames[:] = [d for d in dirnames if d != "__pycache__"]
                for f in sorted(filenames):
                    if f.endswith(".py"):
                        yield os.path.join(dirpath, f)


def used_names(tree: ast.AST) -> set:
    used = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Attribute):
            root = node
            while isinstance(root, ast.Attribute):
                root = root.value
            if isinstance(root, ast.Name):
                used.add(root.id)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            # __all__ entries and doctest-ish references count as usage.
            used.add(node.value)
    return used


def check_file(path: str) -> list:
    rel = os.path.relpath(path, ROOT)
    src = open(path, encoding="utf-8").read()
    problems = []
    try:
        tree = ast.parse(src, filename=rel)
    except SyntaxError as e:
        return [f"{rel}:{e.lineno}: syntax error: {e.msg}"]

    # W291/W191: trailing whitespace, tabs in indentation.
    for i, line in enumerate(src.splitlines(), 1):
        if line != line.rstrip():
            problems.append(f"{rel}:{i}: trailing whitespace")
        stripped = line.lstrip()
        indent = line[: len(line) - len(stripped)]
        if "\t" in indent:
            problems.append(f"{rel}:{i}: tab in indentation")

    used = used_names(tree)

    # F401/F403 on module-level imports (conftest-style mid-file too).
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                name = alias.asname or alias.name.split(".")[0]
                if name.startswith("_"):
                    continue
                if name not in used:
                    problems.append(
                        f"{rel}:{node.lineno}: unused import '{name}'"
                    )
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue
            # Submodule re-exports in package __init__.py are API surface.
            if os.path.basename(path) == "__init__.py" and node.level:
                continue
            for alias in node.names:
                if alias.name == "*":
                    problems.append(
                        f"{rel}:{node.lineno}: star import from "
                        f"'{node.module}'"
                    )
                    continue
                name = alias.asname or alias.name
                if name.startswith("_"):
                    continue
                if name not in used:
                    problems.append(
                        f"{rel}:{node.lineno}: unused import '{name}'"
                    )

    # F811-lite: duplicate top-level def/class names.
    seen = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if node.name in seen:
                problems.append(
                    f"{rel}:{node.lineno}: redefinition of '{node.name}' "
                    f"(first at line {seen[node.name]})"
                )
            seen[node.name] = node.lineno

    # B006: mutable default arguments.
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for d in list(node.args.defaults) + [
                d for d in node.args.kw_defaults if d is not None
            ]:
                if isinstance(d, (ast.List, ast.Dict, ast.Set)):
                    problems.append(
                        f"{rel}:{node.lineno}: mutable default argument "
                        f"in '{node.name}'"
                    )
    return problems


def main() -> int:
    all_problems = []
    n = 0
    for path in iter_files():
        n += 1
        all_problems.extend(check_file(path))
    for p in all_problems:
        print(p)
    print(f"lint: {n} files, {len(all_problems)} problems",
          file=sys.stderr)
    return 1 if all_problems else 0


if __name__ == "__main__":
    raise SystemExit(main())
