"""Builds the port's CUDA C++ sources into shared libraries at first use.

Each source under `ops/csrc/` has a plain C interface and is compiled by
`nvcc` for Hopper (`sm_90a`) into `fasttrack_tpu_torch/_build/`, keyed by
a hash of the source and the flags, then loaded with ctypes by its
wrapper. Only sources in the package are built; nothing is fetched. The
build happens on the first call with a CUDA tensor, never on import;
`build_all` compiles several sources side by side.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME (default /usr/local/cuda), else from PATH."""
    home = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.access(home, os.X_OK):
        return home
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def library_path(source: Path) -> Path:
    key = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{source.stem}-{key[:16]}.so"


def nvcc_command(nvcc: str, source: Path, output: Path) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(output), str(source)]


def build_all(source_names) -> list[Path]:
    """Compiled libraries for csrc/<name> of every name, in order. Those not
    yet present are compiled together, one nvcc process per source."""
    sources = [CSRC_DIR / name for name in source_names]
    outs = [library_path(source) for source in sources]
    running = []
    for source, out in zip(sources, outs):
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            nvcc_command(find_nvcc(), source, tmp),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        running.append((source, out, tmp, proc))
    failures = []
    for source, out, tmp, proc in running:
        _, stderr = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed on {source.name}:\n{stderr}")
        else:
            os.replace(tmp, out)  # atomic: another process never loads a partial file
    if failures:
        raise RuntimeError("\n".join(failures))
    return outs

