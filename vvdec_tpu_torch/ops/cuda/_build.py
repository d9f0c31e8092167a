"""Build a source of csrc/ into a shared library and load it.

Route (b) of the port's kernel build: nvcc compiles each CUDA source
(csrc/<name>.cu), which has a plain C interface, for sm_90a into
build/kernels/ at the repository root, keyed by a hash of the source and
the flags; ctypes loads it.  A plain C source of the host (csrc/<name>.c,
no .cu of that name) takes the same route through the host compiler
(`cc -O2 -shared -fPIC`).  A build runs once per process and source; a
failed build raises KernelError with the compiler's output, and so does a
library ctypes cannot load; a build that succeeds keeps the compiler's
output (`-Xptxas -v`: each kernel's registers, spills and shared memory)
beside the library (`build_log`).  Nothing runs at import time.
`setup_counts` counts, for the process, the builds (compiler runs) and
the loads (ctypes) of the CUDA kernels and the seconds each took, and
under "host_" those of the host's C sources.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CC_FLAGS = ("-O2", "-shared", "-fPIC")

_loaded: dict = {}
setup_counts = {"builds": 0, "build_s": 0.0, "loads": 0, "load_s": 0.0,
                "host_builds": 0, "host_build_s": 0.0, "host_loads": 0,
                "host_load_s": 0.0}


class KernelError(RuntimeError):
    """A hand-written kernel failed to build, load or launch.  A fault of
    the device, never of the stream: the decoder's concealment lets it
    through (decoder.is_device_fault)."""


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError("nvcc not found (PATH, /usr/local/cuda/bin)")


def _cc() -> str:
    for cand in ("cc", "gcc"):
        path = shutil.which(cand)
        if path:
            return path
    raise KernelError("no host C compiler (cc, gcc) on PATH")


def _route(name: str) -> tuple:
    """(source file name, compiler finder, flags, setup_counts prefix) of
    csrc/<name>: nvcc for a CUDA source, the host compiler for a plain C
    one."""
    if os.path.exists(os.path.join(CSRC, name + ".cu")):
        return name + ".cu", _nvcc, NVCC_FLAGS, ""
    return name + ".c", _cc, CC_FLAGS, "host_"


def library_path(name: str) -> str:
    """build/kernels/<name>_<hash>.so for csrc/<name>.cu (or .c)."""
    src, _, flags, _ = _route(name)
    with open(os.path.join(CSRC, src), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode())
    return os.path.join(BUILD_DIR, f"{name}_{digest.hexdigest()[:16]}.so")


def build_kernel(name: str) -> str:
    """Compile csrc/<name>.cu (or .c) unless its hashed library exists;
    returns the library path."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    src, compiler, flags, key = _route(name)
    exe = compiler()
    tool = os.path.basename(exe)
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [exe, *flags, "-o", tmp, os.path.join(CSRC, src)]
    t0 = time.perf_counter()
    try:
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=600)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise KernelError(f"{tool} failed for csrc/{src}: {e}") from e
        if r.returncode != 0:
            raise KernelError(
                f"{tool} failed for csrc/{src} (rc {r.returncode}):\n"
                f"{r.stdout}\n{r.stderr}")
        with open(out[:-3] + ".log", "w") as f:
            f.write(r.stdout + r.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
        setup_counts[key + "builds"] += 1
        setup_counts[key + "build_s"] += time.perf_counter() - t0
    return out


def build_log(name: str) -> str:
    """The compiler's output of the build of csrc/<name>.cu or .c (""
    where the library was built without it)."""
    path = library_path(name)[:-3] + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def load_kernel(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu or .c, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        path = build_kernel(name)
        key = _route(name)[3]
        t0 = time.perf_counter()
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            raise KernelError(f"cannot load {path}: {e}") from e
        finally:
            setup_counts[key + "loads"] += 1
            setup_counts[key + "load_s"] += time.perf_counter() - t0
        _loaded[name] = lib
    return lib
