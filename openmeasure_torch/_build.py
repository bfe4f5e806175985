"""Build the port's native sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with
a plain C interface, ``build/openmeasure_torch/lib<name>-<hash>.so`` beside
the package, where the hash covers the flags and every source of
``csrc/``: an edited source builds anew, an unchanged one is reused.  A
build with preprocessor defines (a measuring variant, such as
``-DCHOL_STAMPS``) is a library of its own, its defines in its name.  The
host C++ sources, ``native/<name>.cpp`` (the ray caster of unstructured
meshes), go the same way through ``g++`` with OpenMP.  The compiler writes
to a temporary name that is renamed into place only after it succeeds, so
a cut build is never loaded.  Nothing is built at import: the first call of
a wrapper builds its library through :func:`load_library`.

Only the repository's sources, the CUDA toolkit and the system's ``g++``
are used.  A missing compiler or a failed build raises with the compiler's
output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
NATIVE = Path(__file__).resolve().parent / "native"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "openmeasure_torch"

# sm_90a: Hopper with its architecture-specific instructions; -Xptxas -v
# reports each kernel's registers, shared memory and spills into the log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the host caster: OpenMP over rays; ISO C++17 with no -march leaves
# a·b + c unfused, so every machine rounds the exact cell test alike
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-fopenmp")

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


def _source(name: str) -> Tuple[Path, Tuple[str, ...]]:
    """The source of ``name`` and its compiler's flags: ``csrc/<name>.cu``
    with nvcc's, else the host source ``native/<name>.cpp`` with g++'s."""
    src = CSRC / f"{name}.cu"
    if src.exists():
        return src, NVCC_FLAGS
    return NATIVE / f"{name}.cpp", GXX_FLAGS


def _flags(defines: Tuple[str, ...],
           base: Tuple[str, ...] = NVCC_FLAGS) -> Tuple[str, ...]:
    return base + tuple(f"-D{d}" for d in defines)


def _lib_path(name: str, defines: Tuple[str, ...] = ()) -> Path:
    src, base = _source(name)
    h = hashlib.sha256(" ".join(_flags(defines, base)).encode())
    for p in sorted(src.parent.glob("*.cuh")) + [src]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    tag = "".join(f"-{d.lower()}" for d in defines)
    return BUILD_DIR / f"lib{name}{tag}-{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """The compiler output kept beside the built library (empty if none)."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _compile(name: str, out: Path, defines: Tuple[str, ...]) -> None:
    """``nvcc`` on ``csrc/<name>.cu``, or ``g++`` on ``native/<name>.cpp``,
    into ``out``, by way of a temporary name; the compiler output (for
    nvcc the ``-Xptxas -v`` lines) is kept beside the library."""
    src, base = _source(name)
    cuda = src.suffix == ".cu"
    cc = _nvcc() if cuda else "g++"
    where = f"{'csrc' if cuda else 'native'}/{src.name}"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    try:
        proc = subprocess.run(
            [cc, *_flags(defines, base), "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        raise RuntimeError(f"{cc} was not found; {where} is built from "
                           "source at first use and needs it.") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{Path(cc).name} failed on {where} "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    out.with_suffix(".log").write_text(proc.stdout)
    os.replace(tmp, out)


def host_sources() -> list:
    """Names of the host C++ sources (``native/<name>.cpp``)."""
    return sorted(p.stem for p in NATIVE.glob("*.cpp"))


def load_all() -> list:
    """Build (where needed) and load every source of ``csrc/`` and
    ``native/``, one compiler per source, all started together; returns
    the names (the host sources' as ``native/<name>``)."""
    from concurrent.futures import ThreadPoolExecutor
    names = sources()
    hosts = host_sources()
    with ThreadPoolExecutor(max_workers=max(1, len(names) + len(hosts))) as ex:
        for fut in [ex.submit(load_library, n) for n in names + hosts]:
            fut.result()
    return names + [f"native/{n}" for n in hosts]


def load_library(name: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (or of the host source
    ``native/<name>.cpp``) built with ``-D`` each of ``defines`` (none for
    the kernel a user's path runs), built first if needed."""
    lib = _loaded.get((name, defines))
    if lib is None:
        path = _lib_path(name, defines)
        if not path.exists():
            _compile(name, path, defines)
        lib = _loaded[name, defines] = ctypes.CDLL(str(path))
    return lib
