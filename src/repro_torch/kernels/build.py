"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds).  Libraries go to ``build/repro_torch/`` at the root of
the checkout, named by a hash of every file under ``csrc/`` and of the
flags: a changed source rebuilds, an unchanged one is loaded as it is.
``build()`` starts one ``nvcc`` per missing library, all at once, and
raises with ``nvcc``'s stderr if any of them fails.

Nothing here runs when the module is imported: the first launch of a kernel
(or an explicit ``build()``) compiles it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNEL_NAMES = ("bc_fused", "flash_attention", "paged_attention",
                "paged_gather")


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and PATH); "
                       "the CUDA kernels build only where the toolkit is "
                       "installed")


def source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{source_digest()}.so"


def build(names: Iterable[str] = KERNEL_NAMES) -> Dict[str, float]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    process per source, all started together.  Returns the wall seconds
    spent (0.0 for a library that was already built) per name."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n).exists()]
    out = {n: 0.0 for n in names}
    if not todo:
        return out
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        target = library_path(name)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, target)
    failures: List[str] = []
    for name, (proc, tmp, target) in procs.items():
        stdout, stderr = proc.communicate()
        out[name] = time.perf_counter() - t0
        target.with_suffix(".log").write_text(stdout + stderr)
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu "
                            f"(exit {proc.returncode}):\n{stderr}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
    if failures:
        raise RuntimeError("\n".join(failures))
    return out


class Kernel:
    """One compiled library and the count of its kernel launches.

    ``signatures`` maps each exported C function to its ``ctypes`` argument
    types; every function returns a ``cudaError_t`` as an int.  ``launch``
    calls one on the current CUDA stream (passed last), raises if it
    returned an error, and otherwise adds one to ``launches`` and to
    ``fn_launches[fn]`` (one count per exported function, i.e. per lane)."""

    def __init__(self, name: str, signatures: Dict[str, Sequence]):
        self.name = name
        self.signatures = dict(signatures)
        self.launches = 0
        self.fn_launches = {fn: 0 for fn in self.signatures}
        self._lib: Optional[ctypes.CDLL] = None

    def reset_counts(self) -> None:
        self.launches = 0
        self.fn_launches = {fn: 0 for fn in self.signatures}

    @property
    def source(self) -> Path:
        return CSRC / f"{self.name}.cu"

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            build([self.name])
            lib = ctypes.CDLL(str(library_path(self.name)))
            for fn, argtypes in self.signatures.items():
                getattr(lib, fn).argtypes = [*argtypes, ctypes.c_void_p]
                getattr(lib, fn).restype = ctypes.c_int
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def launch(self, fn: str, device: torch.device, *args) -> None:
        lib = self.lib()
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.name}.{fn}: CUDA error {err} "
                               f"({lib.error_string(err).decode()})")
        self.launches += 1
        self.fn_launches[fn] += 1


def check_cuda(name: str, tensors: Dict[str, torch.Tensor],
               dtypes: Dict[str, Sequence[torch.dtype]]) -> torch.device:
    """Raise unless every tensor is contiguous, on one CUDA device, and of
    an accepted dtype.  Returns that device."""
    device = None
    for key, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {key} is on {t.device}, expected CUDA")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, the other "
                             f"inputs on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if key in dtypes and t.dtype not in dtypes[key]:
            raise ValueError(f"{name}: {key} has dtype {t.dtype}, expected "
                             f"one of {tuple(dtypes[key])}")
    return device


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
