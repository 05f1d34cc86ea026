"""Build ``csrc/*.cu`` with nvcc into ``build/`` and load them with ctypes.

Each source is one shared library with a plain C interface, so it compiles
in seconds (no PyTorch headers).  The build happens at first use; a library
is rebuilt when its source is newer.  Several sources build in parallel, one
nvcc each, under an exclusive lock on ``build/build.lock`` (``flock``,
released by the kernel if the process dies): processes that start together
on a fresh tree, as the ranks of a mesh do, compile each source once.  nvcc runs with ``-Xptxas -v``; its output is kept beside each
library (``build/lib<name>.log``) and :func:`ptxas_usage` reads each kernel's
registers and spill bytes from it.  Nothing here runs when the module is
imported: the CPU tests import every module on machines with no nvcc.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return nvcc


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def log_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.log"


def _stale(name: str) -> bool:
    """No library, a source newer than it, or no nvcc log beside it (a library
    built without ``-Xptxas -v``)."""
    lib, src = lib_path(name), CSRC / f"{name}.cu"
    return (not lib.exists() or not log_path(name).exists()
            or lib.stat().st_mtime < src.stat().st_mtime)


def build(names: Optional[Iterable[str]] = None) -> List[str]:
    """Compile the stale sources among ``names`` (default: all), in parallel,
    and return the names compiled.

    Each nvcc writes a private temporary file that is renamed into place, so
    processes that build at the same time do not see half-written libraries.
    """
    names = sources() if names is None else list(names)
    if not any(_stale(n) for n in names):
        return []
    with _build_lock():
        # Again under the lock: another process may have built them meanwhile.
        todo = [n for n in names if _stale(n)]
        if todo:
            _compile(todo)
    return todo


@contextlib.contextmanager
def _build_lock():
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _compile(todo: List[str]) -> None:
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = BUILD_DIR / f".lib{n}.{os.getpid()}.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            log_path(n).write_text(log)
            os.replace(tmp, lib_path(n))
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))


_LENGTH = re.compile(r"\d+")
_TEMPLATE_ARG = re.compile(r"L[ij](?P<literal>\d+)E|(?P<builtin>[fdijb])|(?P<length>\d+)")
_BUILTIN = {"f": "float", "d": "double", "i": "int", "j": "unsigned int", "b": "bool"}


def kernel_name(symbol: str) -> str:
    """``flash_fwd_wgmma<256>`` from a kernel's mangled symbol: the last
    component of its name (nvcc names an anonymous namespace after the file,
    as one more component), with integer or named-type template arguments.
    Any other symbol comes back as it is."""
    if not symbol.startswith("_Z"):
        return symbol
    nested = symbol.startswith("_ZN")
    pos, name, args = 3 if nested else 2, None, []
    while m := _LENGTH.match(symbol, pos):
        pos = m.end() + int(m[0])
        name = symbol[m.end():pos]
        if not nested:
            break
    if name is None:
        return symbol
    if symbol.startswith("I", pos):
        pos += 1
        while m := _TEMPLATE_ARG.match(symbol, pos):
            if m["length"]:
                pos = m.end() + int(m["length"])
                args.append(symbol[m.end():pos])
            else:
                pos = m.end()
                args.append(m["literal"] or _BUILTIN[m["builtin"]])
    return f"{name}<{', '.join(args)}>" if args else name


def ptxas_usage(log: str) -> List[Dict[str, object]]:
    """Each kernel's resources from nvcc's ``-Xptxas -v`` output: ``kernel``
    (:func:`kernel_name` of its symbol), ``registers``, ``spill_stores`` and
    ``spill_loads`` (bytes), ``static_smem`` (bytes; dynamic shared memory is
    requested at launch and does not appear here)."""
    kernels: Dict[str, Dict[str, object]] = {}
    props, last = None, None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            last = m[1]
            kernels.setdefault(last, {"registers": 0, "spill_stores": 0, "spill_loads": 0,
                                      "static_smem": 0})
        elif m := re.search(r"Function properties for (\S+)", line):
            props = m[1]
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            if props in kernels:
                kernels[props].update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        elif m := re.search(r"Used (\d+) registers", line):
            if last in kernels:
                kernels[last]["registers"] = int(m[1])
                if sm := re.search(r"(\d+) bytes smem", line):
                    kernels[last]["static_smem"] = int(sm[1])
    return [{"kernel": kernel_name(symbol), **use} for symbol, use in kernels.items()]


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = ctypes.CDLL(str(lib_path(name)))
    return lib


def raise_on(err: int, what: str) -> None:
    """Raise for the return value of a C entry that launches a kernel: a
    cudaError_t, or minus the CUresult of a tensor map that could not be
    encoded; 0 is success."""
    if err < 0:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled failed: CUresult {-err}")
    if err:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")
