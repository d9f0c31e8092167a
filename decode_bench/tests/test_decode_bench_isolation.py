"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program: top-level names compared whole
(the port's name, vvdec_tpu_torch, begins with the JAX package's)."""

import ast
import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = {"jax", "jaxlib", "flax", "vvdec_tpu", "bench", "chip_smoke"}
PROGRAM = {"vvdec_tpu_torch", "torch"}


def imported_top_names(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources(sub: str = "") -> list:
    out = []
    for root, dirs, files in os.walk(os.path.join(BENCH, sub)):
        dirs[:] = [d for d in dirs if d not in ("tests", ".cache")]
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return out


def test_no_source_imports_jax_or_the_jax_package():
    for path in sources():
        assert not imported_top_names(path) & JAX, path


def test_refdec_imports_nothing_of_the_program():
    for path in sources("refdec"):
        assert not imported_top_names(path) & (JAX | PROGRAM), path


def test_top_names_are_compared_whole():
    assert "vvdec_tpu_torch".split(".")[0] not in JAX
    import run
    assert run.FORBIDDEN == ("jax", "jaxlib", "flax", "vvdec_tpu")


def test_refdec_loads_alone():
    """Every refdec module imported in a fresh process loads no JAX, no
    program module and no torch."""
    code = (
        "import sys, pkgutil, importlib\n"
        f"sys.path.insert(0, {BENCH!r})\n"
        "import refdec\n"
        "for m in pkgutil.walk_packages(refdec.__path__, 'refdec.'):\n"
        "    importlib.import_module(m.name)\n"
        "import refdec.decoder\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules} & "
        "{'jax', 'jaxlib', 'flax', 'vvdec_tpu', 'vvdec_tpu_torch', "
        "'torch'})\n"
        "print(bad)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=BENCH)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"
