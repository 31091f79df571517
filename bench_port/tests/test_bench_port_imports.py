"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the port.  Module names are compared by their
top-level part, whole: ``sift_tpu_torch`` is not ``sift_tpu``."""

import ast
import subprocess
import sys

from conftest import HERE, ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "sift_tpu")


def _loaded_after(code: str) -> list:
    probe = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"{code}\n"
        "print('\\n'.join(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, check=True, cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    return out.stdout.split()


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    top = _loaded_after(
        "import runpy\n"
        "runpy.run_path('bench_port/run.py', run_name='bench_port_run')\n"
        "import sift_tpu_torch\n"
        "from bench_port import measure, engine, control, reference\n"
        "from bench_port import spec\n"
        "[spec.metric_reader(m['name']) for m in"
        " spec.load_benchmark()['per_layer']]\n")
    assert "sift_tpu_torch" in top and "torch" in top
    assert not [m for m in top if m in FORBIDDEN]


def test_the_reference_loads_nothing_of_the_port():
    top = _loaded_after("import bench_port.reference\n"
                        "import bench_port.reference.compare\n")
    assert not [m for m in top if m in FORBIDDEN + ("sift_tpu_torch",)]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_of_the_benchmark_names_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)
            if "reference" in path.relative_to(HERE).parts:
                assert name.split(".")[0] != "sift_tpu_torch", (path, name)
