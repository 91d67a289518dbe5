"""What the benchmark loads: nothing of JAX or of the JAX package (by
whole top-level name: the port's name begins with the JAX package's), and
a reference that loads nothing of the program. The change that adds the
benchmark changes no file outside it, its records and the repository's
top-level documents."""

import ast
import json
import subprocess
import sys

import pytest

from helpers import DATA

ROOT = DATA.parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "far_tpu"}
LOAD_ALL = """
import json, sys
sys.path.insert(0, {root!r})
from pathlib import Path
import h100bench.run
from h100bench.trace import load_module
root = Path({root!r})
for d in {dirs!r}:
    for p in sorted((root / "h100bench" / d).glob("*.py")):
        load_module(p)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(dirs, root=ROOT):
    out = subprocess.run([sys.executable, "-c", LOAD_ALL.format(root=str(root), dirs=dirs)],
                         capture_output=True, text=True, check=True, cwd=root)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    mods = loaded(["entries", "metrics", "e2e", "kernels", "tools"])
    assert not mods & FORBIDDEN, mods & FORBIDDEN
    assert "far_tpu_torch" in mods


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys, json; sys.path.insert(0, %r); import h100bench.reference.judge, "
            "h100bench.reference.synthetic, h100bench.reference.weights; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT)
    mods = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not mods & (FORBIDDEN | {"far_tpu_torch"})
    for p in (ROOT / "h100bench" / "reference").rglob("*.py"):
        for node in ast.walk(ast.parse(p.read_text())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) else []
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN | {"far_tpu_torch"}, (p, n)


ALLOWED = ("BENCHMARK.json", ".gitignore", "PERF_LEDGER.jsonl")


def allowed(f):
    """The benchmark's folder, its records, or a top-level Markdown document."""
    return f.startswith("h100bench/") or f in ALLOWED or ("/" not in f and f.endswith(".md"))


def test_the_benchmark_pr_touches_nothing_else():
    """The files of the change that added BENCHMARK.json (or, before it is
    committed, the working tree's changes) lie in the benchmark's folder or
    are the benchmark's records."""
    def git(*a):
        return subprocess.run(["git", *a], cwd=ROOT, capture_output=True, text=True)

    if git("rev-parse", "--git-dir").returncode:
        pytest.skip("not a git checkout")
    added = git("log", "--diff-filter=A", "--format=%H", "--", "BENCHMARK.json").stdout.split()
    if added:
        files = git("show", "--name-only", "--format=", added[-1]).stdout.split()
    else:
        files = [ln[3:] for ln in git("status", "--porcelain", "-uall").stdout.splitlines()]
    bad = [f for f in files if not allowed(f)]
    assert not bad, bad
