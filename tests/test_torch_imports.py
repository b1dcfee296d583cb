"""saena_tpu_torch and chip_smoke.py stand alone: they import neither jax
nor anything of saena_tpu, at run time (a fresh interpreter) or anywhere in
their sources (an AST scan)."""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "saena_tpu")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "saena_tpu_torch")):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_import_loads_no_jax_and_no_saena_tpu():
    code = ("import sys, saena_tpu_torch, saena_tpu_torch.convert, "
            "saena_tpu_torch.amg.solvers, saena_tpu_torch._native, "
            "saena_tpu_torch.native, saena_tpu_torch.parallel.dist_setup, "
            "saena_tpu_torch.api, saena_tpu_torch.amg.graphs, "
            "saena_tpu_torch.profiling, saena_tpu_torch.vector, "
            "saena_tpu_torch.oracles, saena_tpu_torch.io.readers, "
            "saena_tpu_torch.io.nektar, saena_tpu_torch.config, "
            "saena_tpu_torch.amg.pcoarsen, saena_tpu_torch.ops.bspgemm, "
            "saena_tpu_torch.ops.spgemm, "
            "saena_tpu_torch.parallel.comm, saena_tpu_torch.parallel.halo, "
            "saena_tpu_torch.parallel.sharded, saena_tpu_torch.parallel.multihost\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(','.join(bad))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_no_jax_and_no_saena_tpu(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


KERNEL_WRAPPERS = ("dia_spmv", "strip_spmv", "strip8_spmv", "ell_spmv", "csr_spgemm")


def test_launches_are_counted_in_runtime_only():
    """The graph runner imports no kernel wrapper, and no module of ops/
    keeps a launch counter of its own at module level: the wrappers record
    their launches in runtime.launches."""
    path = os.path.join(ROOT, "saena_tpu_torch", "amg", "graphs.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names += [f"{node.module or ''}.{a.name}" for a in node.names]
    assert not [n for n in names for w in KERNEL_WRAPPERS if f"ops.{w}" in n]
    ops = os.path.join(ROOT, "saena_tpu_torch", "ops")
    counters = []
    for name in sorted(os.listdir(ops)):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(ops, name)) as f:
            body = ast.parse(f.read(), name).body
        for node in body:
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                targets = [node.target]
            else:
                continue
            counters += [f"{name}:{t.id}" for tgt in targets for t in ast.walk(tgt)
                         if isinstance(t, ast.Name) and t.id.endswith("launches")]
    assert not counters
