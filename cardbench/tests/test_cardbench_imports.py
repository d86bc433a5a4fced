"""What a run imports: nothing of the JAX stack or the JAX package (by whole
top-level name: the port's own name begins with the package's), and the
references nothing of the port."""
import ast
import subprocess
import sys

from cardbench.harness import FORBIDDEN
from cardbench.tests.tiny import ROOT

BENCH_DIR = ROOT / "cardbench"


def imported(path) -> set[str]:
    """Top-level names a file imports (relative imports as ``cardbench``)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            out.add("cardbench" if node.level else (node.module or "").split(".")[0])
    return out


def test_no_file_imports_the_jax_stack():
    for path in BENCH_DIR.rglob("*.py"):
        assert not imported(path) & set(FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    """The reference and the modules of the benchmark it imports."""
    for name in ("reference/__init__.py", "reference/dense.py", "model_config.py",
                 "__init__.py"):
        assert "repro_torch" not in imported(BENCH_DIR / name), name
    code = ("import sys; sys.path[:0] = [sys.argv[1]]; import cardbench.reference.dense; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'repro_torch', 'jax', "
            "'repro'}))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                         text=True, check=True, timeout=120).stdout.strip()
    assert out == "[]"


def test_run_path_loads_no_jax():
    """Everything a run imports, in a fresh process."""
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[1] + '/src']; "
            "from cardbench import harness, calibrate; "
            "from cardbench.drivers import decode, pipeline_ranks; "
            "import repro_torch.runtime.serve, repro_torch.runtime.pipeline_ranks, "
            "repro_torch.kernels.flash_attention.kernel; "
            "print(harness.forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                         text=True, check=True, timeout=300).stdout.strip()
    assert out == "[]"
