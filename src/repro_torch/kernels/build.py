"""Build and bind the port's CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``.  Builds
happen at first use (or all at once, in parallel, through ``build_all``),
into ``_build/`` beside this file, named by a hash of the source, the shared
headers (``csrc/*.cuh``) and the flags, so that an edited source is
rebuilt.  Nothing here runs at import.

A ``CudaKernel`` is one C entry point plus what the port reports about it:
the TPU kernel it replaces and ``launches``, the number of times its wrapper
has launched it in this process.

Each public kernel function is a ``torch.library`` op of the ``repro_torch``
namespace (``register_op``): its CUDA implementation launches the kernel,
its CPU implementation is the plain version of ``kernels/ref.py``, and its
fake implementation gives the output shapes and dtypes only, for tracing
without a card: under ``FakeTensorMode``, and as the op's Meta kernel on
meta tensors (launch/dryrun.py).  The dispatcher picks one by the inputs
(a fake or meta tensor takes the fake one), so there is still no switch
that sends a CUDA tensor to the plain version.  The ops are defined with
the low-level ``torch.library.Library`` API; ``chip_smoke.py`` phase
``kernels`` times a call through each op against its launch called
directly, and through a ``torch.library.custom_op`` around the same
launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Iterable, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels are built from source at first use")


def library_path(source: str) -> Path:
    """The library of ``source``, named by a hash of the source, the shared
    headers of csrc/ and the flags."""
    src = CSRC / source
    text = src.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def _start_build(source: str):
    """Start nvcc for one source; returns (target, tmp, process) or None
    when the library is already built."""
    target = library_path(source)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, tmp, proc


def build_all(sources: Iterable[str]) -> Dict[str, str]:
    """Compile every source at once (one nvcc each, all started together)
    and return each source's compiler output (ptxas register and shared
    memory report).  Raises if any build fails."""
    with _LOCK:
        started = {s: _start_build(s) for s in sources}
        logs, failed = {}, []
        for source, job in started.items():
            if job is None:
                logs[source] = "(already built)"
                continue
            target, tmp, proc = job
            out, _ = proc.communicate()
            logs[source] = out
            if proc.returncode != 0:
                failed.append(f"{source}:\n{out}")
                continue
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load_library(source: str) -> ctypes.CDLL:
    with _LOCK:
        lib = _LIBS.get(source)
    if lib is None:
        if not library_path(source).exists():
            build_all([source])
        with _LOCK:
            lib = _LIBS.setdefault(
                source, ctypes.CDLL(str(library_path(source))))
    return lib


@dataclass
class CudaKernel:
    """One CUDA entry point: ``int symbol(args..., void* stream)`` returning
    ``cudaGetLastError()`` after the launch (or, negated, the ``CUresult``
    of a CUDA call that failed before it)."""
    name: str
    source: str                   # file under csrc/
    symbol: str
    argtypes: Sequence            # ctypes types, stream excluded
    replaces: str                 # the TPU kernel, file:line
    launches: int = 0
    _fn: object = field(default=None, repr=False)

    def _bind(self):
        if self._fn is None:
            fn = getattr(load_library(self.source), self.symbol)
            fn.argtypes = [*self.argtypes, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, *args, stream: int) -> None:
        """Launch on ``stream`` (``torch.cuda.current_stream().cuda_stream``)
        and count it; raises on a refused launch."""
        err = self._bind()(*args, stream)
        if err != 0:
            what = (f"CUresult {-err}" if err < 0 else f"cudaError {err}")
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: "
                               f"{what}")
        self.launches += 1


def source_path(kernel: CudaKernel) -> str:
    """The kernel's source, relative to the repository root."""
    return str((CSRC / kernel.source).relative_to(CSRC.parents[3]))


NAMESPACE = "repro_torch"
_LIB = torch.library.Library(NAMESPACE, "DEF")


def register_op(schema: str, *, cuda: Callable, cpu: Callable,
                fake: Callable):
    """Define the op ``repro_torch::<name>`` of ``schema`` with its three
    implementations and return its ``OpOverload`` (module docstring).  An
    implementation returns new tensors, never an input or a view of one."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, cuda, "CUDA")
    _LIB.impl(name, cpu, "CPU")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default
