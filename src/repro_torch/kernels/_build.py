"""Build the CUDA sources in ``csrc/`` and load them with ctypes.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds).
Libraries are cached in ``build/repro_torch_kernels/`` at the root of the
checkout, which ``.gitignore`` lists, by the hash of their source, the
``csrc`` headers it includes (``hopper.cuh``) and the flags. `build` starts one ``nvcc`` per missing library, all
at once, and waits for all of them.

Every C entry point launches on the stream it is given, allocates nothing
and returns ``cudaGetLastError()`` after its launch; `check` turns a
non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = ("psum_matmul", "conv2d_psum", "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)
_LIBS: dict[str, ctypes.CDLL] = {}


def build_dir() -> pathlib.Path:
    """``build/repro_torch_kernels`` in the checkout (found by its
    ``pyproject.toml``); next to the package when installed elsewhere."""
    root = CSRC.parents[3]
    if (root / "pyproject.toml").is_file():
        return root / "build" / "repro_torch_kernels"
    return CSRC.parent / "_build_cache"


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def sources(name: str) -> list[str]:
    """``<name>.cu`` and every ``csrc`` header it includes with
    ``#include "..."``, directly or through another header."""
    found, todo = [], [f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path not in found:
            found.append(path)
            todo.extend(_INCLUDE.findall((CSRC / path).read_text()))
    return found


def library_path(name: str) -> pathlib.Path:
    """The library's path in the cache, named by a digest of its source,
    every header the source includes and the flags: a change to any of them
    builds it anew."""
    digest = hashlib.sha256()
    for path in sources(name):
        digest.update(path.encode() + b"\0" + (CSRC / path).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, pathlib.Path]:
    """Compile every library in ``names`` that is not built yet, with one
    ``nvcc`` per source running in parallel. The compiler's report
    (registers, shared memory, spills) is kept in ``<library>.log``."""
    paths = {name: library_path(name) for name in names}
    todo = {name: p for name, p in paths.items() if not p.is_file()}
    if not todo:
        return paths
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        path.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for one source, built first if needed."""
    if name not in _LIBS:
        lib = ctypes.CDLL(str(build([name])[name]))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return _LIBS[name]


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
