"""Nothing under benchmark/ imports JAX or the JAX package (top-level names
compared whole: rtvb_tpu_torch is not rtvb_tpu); nothing under
benchmark/reference/ imports the port."""
import ast
import os

import benchpaths

JAX = {"jax", "jaxlib", "flax", "rtvb_tpu"}


def imported_tops(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def py_files(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_under_benchmark():
    bad = {p: imported_tops(p) & JAX for p in py_files(benchpaths.BENCH)}
    assert not {p: v for p, v in bad.items() if v}


def test_reference_imports_nothing_of_the_port():
    ref = os.path.join(benchpaths.BENCH, "reference")
    bad = {p: imported_tops(p) & {"rtvb_tpu_torch"} for p in py_files(ref)}
    assert not {p: v for p, v in bad.items() if v}


def test_kernel_hooks_name_the_port():
    """The modules the harness imports by name (kernels/*.py HOOK)."""
    from rtvbbench.spec import Benchmark
    for name, mod in Benchmark().kernel_roles().items():
        assert mod.HOOK[0].split(".")[0] == "rtvb_tpu_torch", name


def test_prefix_is_not_a_match():
    """The run's own look at its loaded modules compares whole names."""
    from rtvbbench.cli import forbidden_modules
    assert forbidden_modules(["rtvb_tpu_torch", "rtvb_tpu_torch.render",
                              "torch", "jaxtyping"]) == []
    assert forbidden_modules(["rtvb_tpu.render.sky", "jax.numpy",
                              "flax", "jaxlib"]) == ["flax", "jax", "jaxlib",
                                                     "rtvb_tpu"]
