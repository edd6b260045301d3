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

The wrappers reach the card through the seams below (``on_cpu``,
``on_card``, ``address``, ``ptr``, ``check_cuda`` and ``Kernel.launch``):
``kernels/standin.py`` swaps them for the length of a traced step, so that
a wrapper's card branch runs on fake tensors with only its launch replaced.

Launch counts stay exact when launches are captured into a CUDA graph
(``serve/decode.py`` replays the continuous engine's decode step):
inside ``setup(record)`` a launch counts into ``Kernel.setup_launches``
(warm-up and capture are counted apart), and the record keeps it, so each
``record.replayed()`` after a replay of the graph adds the captured
launches to the kernels' counts, per lane, per plan path and per shape.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNEL_NAMES = ("bc_fused", "bc_grad_w", "flash_attention",
                "paged_attention", "paged_gather", "spectral_matmul")


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


class Work(NamedTuple):
    """What one launch does, as each kernel module's ``work`` counts it (a
    pure function of the launch's shape and lane): its operations, the
    bytes it must move (each input read once, each output written once),
    and the scratch its wrapper allocates beside the output."""
    flops: float
    nbytes: int
    scratch: int = 0


class LaunchRecord:
    """The launches captured into one CUDA graph, by (kernel, exported
    function, plan path, shape).  ``replayed(n)`` adds them ``n`` times to
    the kernels' counts: call it after each replay of the graph."""

    def __init__(self):
        self.launches: Dict[Tuple["Kernel", str, Optional[str],
                                  Optional[str]], int] = {}

    def add(self, kernel: "Kernel", fn: str, path: Optional[str],
            shape: Optional[str] = None) -> None:
        key = (kernel, fn, path, shape)
        self.launches[key] = self.launches.get(key, 0) + 1

    @property
    def total(self) -> int:
        return sum(self.launches.values())

    def replayed(self, n: int = 1) -> None:
        for (kernel, fn, path, shape), count in self.launches.items():
            kernel.count(fn, path, count * n, shape)


_SETUP: List[Optional[LaunchRecord]] = []     # open ``setup`` contexts


@contextlib.contextmanager
def setup(record: Optional[LaunchRecord] = None):
    """Launches inside count apart, in ``Kernel.setup_launches`` (a CUDA
    graph's warm-up and capture); ``record`` also keeps them, so that the
    graph's replays can count them (``LaunchRecord.replayed``)."""
    _SETUP.append(record)
    try:
        yield record
    finally:
        _SETUP.pop()


class Kernel:
    """One compiled library and the count of its kernel launches.

    ``signatures`` maps each exported C function to its ``ctypes`` argument
    types; every function returns a ``cudaError_t`` as an int.  ``launch``
    calls one on the current CUDA stream (passed last), raises if it
    returned an error, and otherwise adds one to ``launches``, to
    ``fn_launches[fn]`` (one count per exported function, i.e. per lane)
    and, where the wrapper names the kernel its plan chose (``path``), to
    ``path_launches[path]`` and, where it names the launch's shape
    (``shape``, a string of the wrapper's own ``shape_key``), to
    ``shape_launches[shape]``; inside ``setup`` it adds one to
    ``setup_launches`` instead (module docstring)."""

    def __init__(self, name: str, signatures: Dict[str, Sequence]):
        self.name = name
        self.signatures = dict(signatures)
        self.reset_counts()
        self._lib: Optional[ctypes.CDLL] = None

    def reset_counts(self) -> None:
        self.launches = 0
        self.fn_launches = {fn: 0 for fn in self.signatures}
        self.path_launches: Dict[str, int] = {}
        self.shape_launches: Dict[str, int] = {}
        self.setup_launches = 0

    def count(self, fn: str, path: Optional[str] = None, n: int = 1,
              shape: Optional[str] = None) -> None:
        self.launches += n
        self.fn_launches[fn] += n
        if path is not None:
            self.path_launches[path] = self.path_launches.get(path, 0) + n
        if shape is not None:
            self.shape_launches[shape] = self.shape_launches.get(shape, 0) + n

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

    def launch(self, fn: str, device: torch.device, *args,
               path: Optional[str] = None,
               shape: Optional[str] = None) -> None:
        lib = self.lib()
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.name}.{fn}: CUDA error {err} "
                               f"({lib.error_string(err).decode()})")
        if not _SETUP:
            self.count(fn, path, shape=shape)
            return
        self.setup_launches += 1
        if _SETUP[-1] is not None:
            _SETUP[-1].add(self, fn, path, shape)


def on_cpu(t: torch.Tensor) -> bool:
    """Whether a wrapper runs its plain version for ``t``: a CPU tensor
    (any other goes to the kernel, which raises off the card).  ``is_cpu``
    reads the flag without building a ``torch.device``."""
    return t.is_cpu


def on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` lies on the card (``check_cuda``'s test)."""
    return t.is_cuda


# a tensor's address: the kernels' pointers and the wrappers' alignment
# checks read it
address = torch.Tensor.data_ptr


def check_cuda(name: str, tensors: Dict[str, torch.Tensor],
               dtypes: Dict[str, Sequence[torch.dtype]],
               contiguous: bool = True) -> torch.device:
    """Raise unless every tensor is on one CUDA device, of an accepted
    dtype and (``contiguous``) contiguous.  Returns that device.  A kernel
    that reads its operands through their strides checks their layout
    itself (``contiguous=False``)."""
    device = None
    for key, t in tensors.items():
        if not on_card(t):
            raise ValueError(f"{name}: {key} is on {t.device}, expected CUDA")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, the other "
                             f"inputs on {device}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if key in dtypes and t.dtype not in dtypes[key]:
            raise ValueError(f"{name}: {key} has dtype {t.dtype}, expected "
                             f"one of {tuple(dtypes[key])}")
    return device


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(address(t))


def cached(store: Dict, key, make):
    """``store[key]``, made by ``make()`` the first time: a kernel's
    constant operand (a DFT panel), built once a device.  Under a
    fake-tensor mode (a traced step) it is kept on the mode instead, as
    ``core/circulant.py:dft_mats`` keeps its matrices: a fake tensor
    belongs to the mode that made it."""
    fake = torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE)
    if fake is not None:
        store = fake.__dict__.setdefault("_kernel_constants", {}).setdefault(
            id(store), {})
    if key not in store:
        store[key] = make()
    return store[key]
