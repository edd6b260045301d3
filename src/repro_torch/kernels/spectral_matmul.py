"""The frequency-domain MAC on its own: per bin f, ``Y[f] = X[f] · W[f]``
as three real products (Gauss).

Port of ``repro/kernels/spectral_matmul.py``, with its signature and
layout.  ``spectral_matmul`` is the wrapper: on CUDA tensors it launches
``csrc/spectral_matmul.cu`` (or raises), on CPU tensors it runs
``spectral_matmul_plain``, the three real products batched over F in plain
PyTorch (``repro/kernels/ref.py:spectral_matmul_ref`` with
``wi = ws1 + wr``).  There is no other fallback.

    xr/xi (F, B, Q), wr/ws1/ws2 (F, Q, P)  ->  yr/yi (F, B, P)
    t1 = (xr + xi)·wr,  t2 = xr·ws1,  t3 = xi·ws2
    yr = t1 - t3,       yi = t1 + t2

``kernels/ops.py:spectral_contract`` adapts it to the ``kernel_fn`` hook of
``core/circulant.py:bc_matmul_spectral``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .build import Kernel, check_cuda, ptr

_VP, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel("spectral_matmul", {"spectral_matmul": [_VP] * 7 + [_I] * 4})


def spectral_matmul_plain(xr, xi, wr, ws1, ws2
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the Gauss identity as three batched products over F."""
    t1 = torch.bmm(xr + xi, wr)
    t2 = torch.bmm(xr, ws1)
    t3 = torch.bmm(xi, ws2)
    return t1 - t3, t1 + t2


def spectral_matmul(xr, xi, wr, ws1, ws2) -> Tuple[torch.Tensor, torch.Tensor]:
    """xr/xi: (F, B, Q) float32; wr/ws1/ws2: (F, Q, P) float32 ->
    (yr, yi), each (F, B, P) float32."""
    if xr.device.type == "cpu":
        return spectral_matmul_plain(xr, xi, wr, ws1, ws2)
    f32 = (torch.float32,)
    names = ("xr", "xi", "wr", "ws1", "ws2")
    tensors = dict(zip(names, (xr, xi, wr, ws1, ws2)))
    device = check_cuda("spectral_matmul", tensors, {n: f32 for n in names})
    if xr.dim() != 3 or wr.dim() != 3:
        raise ValueError(f"spectral_matmul: xr {tuple(xr.shape)} and wr "
                         f"{tuple(wr.shape)} must be (F, B, Q) and (F, Q, P)")
    F, B, Q = xr.shape
    P = wr.shape[-1]
    if xi.shape != xr.shape or wr.shape[:2] != (F, Q) or \
            ws1.shape != wr.shape or ws2.shape != wr.shape:
        raise ValueError(f"spectral_matmul: x planes {tuple(xr.shape)} / "
                         f"{tuple(xi.shape)} do not fit w planes "
                         f"{tuple(wr.shape)} / {tuple(ws1.shape)} / "
                         f"{tuple(ws2.shape)}")
    yr = torch.empty((F, B, P), device=device, dtype=torch.float32)
    yi = torch.empty_like(yr)
    KERNEL.launch("spectral_matmul", device, ptr(xr), ptr(xi), ptr(wr),
                  ptr(ws1), ptr(ws2), ptr(yr), ptr(yi), F, B, Q, P)
    return yr, yi
