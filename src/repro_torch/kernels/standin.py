"""The kernels' stand-in for a traced step (``launch/dryrun.py``).

The dry run traces a step on fake CPU tensors (``FakeTensorMode``), where
every wrapper in ``kernels/*.py`` would take its plain version.  Inside
``standin(cost)`` each wrapper takes its card branch instead, unchanged:
its checks, its ``plan()``, the ``torch.empty`` of its output and of its
scratch all run on the fake tensors.  Only what reads the card is swapped,
for the length of the block:

* ``build.on_cpu`` / ``build.on_card`` (the wrappers' dispatch and
  ``check_cuda``'s device test): a fake tensor counts as on the card, a
  real CPU tensor still takes the plain version;
* ``build.address`` and ``build.ptr`` (the launch's pointers, the
  alignment checks): a fake tensor's offset into its storage, the storage
  itself taken as aligned as the CUDA caching allocator's blocks (512
  bytes); each tensor a pointer is taken of counts as read by the step
  (``StepCost.reads``: its argument bytes);
* ``Kernel.launch``: the kernel is not called.  The launch counts as the
  card counts it (``Kernel.count`` with the same lane, ``path`` and
  ``shape``, times ``dist/spmd.py:count_times()`` for a step traced once
  and run n times), and the kernel module's ``launch_work`` (its ``work``
  from the launch's scalar arguments) is charged to ``cost``
  (``roofline/analysis.py:StepCost.launched``).

The kernels' launch counts are saved on entry and restored on exit, so
``launch_counts()`` inside the block gives the traced step's alone.
Outside the block nothing here runs: a CPU tensor takes the plain
version, a CUDA tensor the kernel or an error.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Dict

from torch._subclasses.fake_tensor import is_fake

from ..dist.spmd import count_times
from . import (bc_fused, bc_grad_w, build, flash_attention, paged,
               paged_attention, spectral_matmul)

# every kernel module: its KERNEL and its launch_work
MODULES = (bc_fused, bc_grad_w, flash_attention, paged, paged_attention,
           spectral_matmul)


def _on_cpu(t) -> bool:
    return t.device.type == "cpu" and not is_fake(t)


def _on_card(t) -> bool:
    return t.device.type == "cuda" or is_fake(t)


def _address(t) -> int:
    if not is_fake(t):
        return t.data_ptr()
    return t.storage_offset() * t.element_size()


def launch_counts() -> Dict[str, Dict[str, Dict[str, int]]]:
    """The kernels' launch counts as a dry-run record's ``launches`` holds
    them: kernel name -> {"lanes": launches per exported function,
    "paths": per plan path, "shapes": per ``shape_key``}, the kernels
    launched only, each map without its zeros.  Inside ``standin``: the
    traced step's; on the card: the counters since their last reset."""
    return {m.KERNEL.name: {
        "lanes": {fn: n for fn, n in m.KERNEL.fn_launches.items() if n},
        "paths": dict(m.KERNEL.path_launches),
        "shapes": dict(m.KERNEL.shape_launches)}
        for m in MODULES if m.KERNEL.launches}


_SAVED = ("launches", "fn_launches", "path_launches", "shape_launches",
          "setup_launches")


@contextlib.contextmanager
def standin(cost=None):
    """The wrappers' card branches on fake tensors for the body of the
    block, each launch counted and charged to ``cost`` (a
    ``roofline/analysis.py:StepCost``; none: counted only)."""
    work = {m.KERNEL: m.launch_work for m in MODULES}

    def launch(kernel, fn, device, *args, path=None, shape=None):
        n = count_times()
        kernel.count(fn, path, n, shape)
        w = work[kernel](fn, [a for a in args
                              if not isinstance(a, ctypes.c_void_p)])
        if cost is not None:
            cost.launched(w.flops, w.nbytes)

    def ptr(t):
        if cost is not None:
            cost.reads(t)
        return ctypes.c_void_p(_address(t))

    seams = {"on_cpu": _on_cpu, "on_card": _on_card, "address": _address,
             "ptr": ptr}
    swapped = [(mod, name, getattr(mod, name))
               for mod in (build, *MODULES) for name in seams
               if name in vars(mod)]
    swapped.append((build.Kernel, "launch", build.Kernel.launch))
    saved = [(m.KERNEL, {a: getattr(m.KERNEL, a) for a in _SAVED})
             for m in MODULES]
    try:
        for mod, name, _ in swapped[:-1]:
            setattr(mod, name, seams[name])
        build.Kernel.launch = launch
        for kernel, _ in saved:
            kernel.reset_counts()
        yield
    finally:
        for mod, name, old in swapped:
            setattr(mod, name, old)
        for kernel, counts in saved:
            for a, v in counts.items():
                setattr(kernel, a, v)
