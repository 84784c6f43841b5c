"""Build the package's CUDA kernels with ``nvcc`` at first use and load them.

Every ``csrc/*.cu`` file is compiled for Hopper (``sm_90a``) by its own
``nvcc``, all started together, and the objects are linked into one shared
library with a plain C interface, which :func:`load` opens with ``ctypes``.
The library lands in ``build/cortex_tpu_torch/`` at the root of the checkout
(git-ignored), named by a hash of the sources, the flags and the ``nvcc``
version, so an edit or another toolkit builds anew and an unchanged tree
loads what is there.  Nothing is compiled when the package is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Sequence

__all__ = [
    "BUILD_DIR", "NVCC_FLAGS", "compile_command", "find_nvcc", "library_name", "link_command",
    "load", "sources",
]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "cortex_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xptxas=-v",
    "-Xcompiler", "-fPIC",
)

# CUDA's default install prefix, tried after PATH and CUDA_HOME.
DEFAULT_CUDA_HOME = "/usr/local/cuda"


def sources() -> List[Path]:
    """The CUDA sources of the package: ``csrc/*.cu``, sorted."""
    return sorted(CSRC_DIR.glob("*.cu"))


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME/bin``, else under
    CUDA's default prefix.  Raises ``RuntimeError`` when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError(
        "cortex_tpu_torch needs nvcc to build its CUDA kernels: none on PATH, "
        "under $CUDA_HOME/bin or under " + DEFAULT_CUDA_HOME + "/bin"
    )


def compile_command(nvcc: str, src: Path, obj: Path) -> List[str]:
    """The command line that compiles one source into the object ``obj``."""
    return [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]


def link_command(nvcc: str, objs: Sequence[Path], out: Path) -> List[str]:
    """The command line that links the objects into the shared library ``out``."""
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(out),
            *map(str, objs)]


def library_name(nvcc_version: str, srcs: Sequence[Path]) -> str:
    """File name of the library built from ``srcs`` by that ``nvcc``."""
    digest = hashlib.sha256(nvcc_version.encode())
    digest.update(" ".join(NVCC_FLAGS).encode())
    for src in srcs:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return f"libcortex_tpu_torch_{digest.hexdigest()[:16]}.so"


@functools.cache
def load() -> ctypes.CDLL:
    """Build the kernels if this tree has not built them yet, and load them.

    The compiler's report (``-Xptxas=-v``: registers and shared memory of each
    kernel) is kept beside the library as ``<library>.log``.
    """
    nvcc = find_nvcc()
    version = subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True, check=True
    ).stdout
    path = BUILD_DIR / library_name(version, sorted(CSRC_DIR.glob("*.cu*")))
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{path.stem}.{os.getpid()}"
        objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
        procs = [
            subprocess.Popen(compile_command(nvcc, src, obj), stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources(), objs)
        ]
        log = ""
        failed = False
        for src, proc in zip(sources(), procs):
            out, _ = proc.communicate()
            log += f"== {src.name}\n{out}"
            failed |= proc.returncode != 0
        tmp = path.with_name(f"{tag}.tmp")
        if not failed:
            link = subprocess.run(link_command(nvcc, objs, tmp), stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            log += f"== link\n{link.stdout}"
            failed = link.returncode != 0
        for obj in objs:
            obj.unlink(missing_ok=True)
        if failed:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed building {path.name}:\n{log}")
        path.with_name(path.name + ".log").write_text(log)
        os.replace(tmp, path)
    return ctypes.CDLL(str(path))
