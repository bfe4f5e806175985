"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with
a plain C interface, ``build/openmeasure_torch/lib<name>-<hash>.so`` beside
the package, where the hash covers the flags and every source of
``csrc/``: an edited source builds anew, an unchanged one is reused.  A
build with preprocessor defines (a measuring variant, such as
``-DCHOL_STAMPS``) is a library of its own, its defines in its name.  The
compiler writes to a temporary name that is renamed into place only after
it succeeds, so a cut build is never loaded.  Nothing is built at import:
the first call of a kernel's wrapper builds it through :func:`load_library`.

Only the repository's sources and the CUDA toolkit are used.  A missing
``nvcc`` or a failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "openmeasure_torch"

# sm_90a: Hopper with its architecture-specific instructions; -Xptxas -v
# reports each kernel's registers, shared memory and spills into the log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}


def sources() -> list:
    """Names of the CUDA sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = []
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    cands.append("nvcc")
    for c in cands:
        try:
            subprocess.run([c, "--version"], capture_output=True, check=True)
            return c
        except (OSError, subprocess.CalledProcessError):
            continue
    raise RuntimeError(
        "nvcc (the CUDA toolkit's compiler) was not found; the port's CUDA "
        "kernels are built from source at first use and need it.")


def _flags(defines: Tuple[str, ...]) -> Tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def _lib_path(name: str, defines: Tuple[str, ...] = ()) -> Path:
    h = hashlib.sha256(" ".join(_flags(defines)).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    tag = "".join(f"-{d.lower()}" for d in defines)
    return BUILD_DIR / f"lib{name}{tag}-{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """The compiler output kept beside the built library (empty if none)."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _compile(name: str, out: Path, defines: Tuple[str, ...]) -> None:
    """``nvcc`` on ``csrc/<name>.cu`` into ``out``, by way of a temporary
    name; the compiler output (the ``-Xptxas -v`` lines) is kept beside
    the library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    proc = subprocess.run(
        [_nvcc(), *_flags(defines), "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    out.with_suffix(".log").write_text(proc.stdout)
    os.replace(tmp, out)


def load_all() -> list:
    """Build (where needed) and load every source of ``csrc/``, one
    ``nvcc`` per source, all started together; returns the names."""
    from concurrent.futures import ThreadPoolExecutor
    names = sources()
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as ex:
        for fut in [ex.submit(load_library, n) for n in names]:
            fut.result()
    return names


def load_library(name: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` built with ``-D`` each of
    ``defines`` (none for the kernel a user's path runs), built first if
    needed."""
    lib = _loaded.get((name, defines))
    if lib is None:
        path = _lib_path(name, defines)
        if not path.exists():
            _compile(name, path, defines)
        lib = _loaded[name, defines] = ctypes.CDLL(str(path))
    return lib
