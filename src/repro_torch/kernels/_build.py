"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on first use
into ``build/kernels/`` at the root of the checkout (listed in .gitignore):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/lib<name>-<hash>.so <src>

The file name carries a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. A failed build
raises with nvcc's output; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from dataclasses import dataclass
from pathlib import Path

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"


@dataclass
class Built:
    name: str
    path: Path
    log: str  # nvcc's output, with the -Xptxas -v register/smem summary ("" if cached)


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the "
                           "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def _target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def build(sources: dict[str, Path]) -> dict[str, Built]:
    """Compile every source not yet built, one nvcc per source, all started
    together. ``sources`` maps a kernel name to its ``.cu`` file."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    built: dict[str, Built] = {}
    running: list[tuple[str, Path, Path, subprocess.Popen]] = []
    nvcc = None
    for name, src in sources.items():
        out = _target(src)
        if out.exists():
            built[name] = Built(name, out, "")
            continue
        nvcc = nvcc or _nvcc()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp, str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, out, Path(tmp), proc))
    failures = []
    for name, out, tmp, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees the whole file or none
        built[name] = Built(name, out, log)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return built


_LIBS: dict[str, ctypes.CDLL] = {}


def load(name: str, src: Path) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build({name: src})[name].path))
        _LIBS[name] = lib
    return lib
