"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` file exports plain C functions. It is compiled by
``nvcc`` for ``sm_90a`` into its own shared library under
``<repo>/build/kernels/`` and loaded with ``ctypes`` (no PyTorch headers,
so a build takes seconds, not minutes). The library's file name carries a
hash of the source, of the ``csrc/`` headers it includes with quotes
(``hopper.cuh``) and of the flags, so an edited source or header rebuilds
and an unchanged one is loaded as it is.

Nothing here runs when the module is imported: a kernel is built on its
first launch (or by ``build_all``, which starts one ``nvcc`` per source
at once). A missing ``nvcc``, a failed build, a device that is not sm_90
or a launch that returns an error raises; nothing falls back.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_INCLUDE = re.compile(rb'^#include "([^"]+)"', re.M)


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under CUDA_HOME; raises if absent."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH or CUDA_HOME): the CUDA kernels "
                       "cannot be built")


def check_meta(t: torch.Tensor):
    """A kernel's meta route takes meta tensors only: it runs the card's
    checks and route choice and returns outputs with the card's shapes and
    dtypes, but launches nothing (``kernels/ops.py``)."""
    if t.device.type != "meta":
        raise RuntimeError(f"meta route called on a {t.device} tensor")


def check_device(t: torch.Tensor):
    """The kernels are compiled for sm_90a only."""
    if t.device.type != "cuda":
        raise RuntimeError(f"CUDA kernel called on a {t.device} tensor")
    cap = torch.cuda.get_device_capability(t.device)
    if cap != (9, 0):
        raise RuntimeError(f"kernels are built for sm_90a; device "
                           f"{torch.cuda.get_device_name(t.device)} is "
                           f"sm_{cap[0]}{cap[1]}")


class CudaKernel:
    """One ``.cu`` source, its shared library, and its launch count.

    ``launches`` counts, by C symbol, the launches ``launch`` made, so a
    run can show that its path went through the kernel.
    """

    def __init__(self, name: str, source: str, functions: dict):
        """``functions``: C symbol -> ctypes argtypes (restype is int, the
        ``cudaError_t`` of the launch)."""
        self.name = name
        self.source = CSRC / source
        self.functions = functions
        self.launches = collections.Counter()
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    def library_path(self) -> pathlib.Path:
        src = self.source.read_bytes()
        h = hashlib.sha256(src)
        for header in sorted(set(_INCLUDE.findall(src))):
            h.update((CSRC / header.decode()).read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:16]}.so"

    def build_command(self, out: pathlib.Path) -> list:
        return [find_nvcc(), *NVCC_FLAGS, "-o", str(out), str(self.source)]

    def _load(self, path: pathlib.Path):
        lib = ctypes.CDLL(str(path))
        for sym, argtypes in self.functions.items():
            fn = getattr(lib, sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        return lib

    def lib(self):
        """The loaded library, built first if this source has no build;
        ``build_log`` then holds the compiler's output of that build."""
        with self._lock:
            if self._lib is None:
                path = self.library_path()
                if not path.exists():
                    build([self])
                log = path.with_suffix(".log")
                if not self.build_log and log.exists():
                    self.build_log = log.read_text()
                self._lib = self._load(path)
            return self._lib

    def launch(self, sym: str, device: torch.device, *args):
        """Call the C launcher on PyTorch's current stream of ``device``;
        raise on error."""
        fn = getattr(self.lib(), sym)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"{self.name}: {sym} launch failed with "
                               f"cudaError {err}")
        self.launches[sym] += 1


def build(kernels) -> None:
    """Build the given kernels' libraries, one ``nvcc`` each, all at once.

    Output goes to a temporary name and is renamed into place, so a
    concurrent loader never sees a half-written library; the compiler's
    output (``ptxas -v``'s registers and spills) is kept beside it as
    ``.log``. Raises with the compiler's output when any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for kern in kernels:
        out = kern.library_path()
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        proc = subprocess.Popen(kern.build_command(tmp),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((kern, proc, tmp, out))
    errors = []
    for kern, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        kern.build_log = log
        if proc.returncode != 0:
            errors.append(f"{kern.name} ({kern.source.name}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
