"""The paper's theory leg (§Theoretical Foundation; port of
``repro/core/theory.py``): block-circulant, and generally
low-displacement-rank (LDR), networks keep the universal approximation
property.

The proof rests on the displacement-rank framework (Pan 2012): a matrix W
has displacement rank γ under the operator ∇(W) = W − Z₁ W Z₁ᵀ, with Z₁ the
cyclic shift.  Circulant matrices have γ ≤ 2; block-circulant matrices
have bounded γ per block.  The computational counterparts:

* ``displacement(W)`` / ``displacement_rank(W)``: the structure
  certificate (numpy, as in ``repro``);
* ``is_block_circulant(W, k)``: the exact structural check (numpy);
* ``universal_approx_demo(...)``: the empirical face of the theorem, a
  two-layer block-circulant net fitted to a continuous target on the unit
  cube, in torch through ``circulant.bc_matmul_fft`` (the ``bc_fused`` and
  ``bc_grad_w`` kernels on the card, their plain versions on the CPU).
  Its weights are drawn from a ``torch.Generator``, not ``jax.random``,
  so it is held to its contract (a large drop in held-out error), not to
  ``repro``'s numbers.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from . import circulant as cc


def cyclic_shift(n: int) -> np.ndarray:
    """Z₁: the unit cyclic down-shift matrix (Pan's displacement operator)."""
    Z = np.zeros((n, n))
    Z[np.arange(1, n), np.arange(n - 1)] = 1.0
    Z[0, n - 1] = 1.0
    return Z


def displacement(W: np.ndarray) -> np.ndarray:
    """∇(W) = W − Z₁ W Z₁ᵀ (square W)."""
    n = W.shape[0]
    Z = cyclic_shift(n)
    return W - Z @ W @ Z.T


def displacement_rank(W: np.ndarray, tol: float = 1e-5) -> int:
    s = np.linalg.svd(displacement(np.asarray(W, np.float64)),
                      compute_uv=False)
    return int((s > tol * max(s[0], 1e-30)).sum())


def is_block_circulant(W: np.ndarray, k: int, tol: float = 1e-5) -> bool:
    """Every k×k block satisfies C[r, c] == C[(r+1)%k, (c+1)%k]."""
    W = np.asarray(W)
    m, n = W.shape
    if m % k or n % k:
        return False
    B = W.reshape(m // k, k, n // k, k)
    rolled = np.roll(np.roll(B, 1, axis=1), 1, axis=3)
    return bool(np.abs(B - rolled).max() <= tol * (np.abs(W).max() + 1e-30))


def universal_approx_demo(
        target: Callable[[np.ndarray], np.ndarray],
        n_in: int = 8, width: int = 256, k: int = 8,
        steps: int = 300, lr: float = 5e-2, seed: int = 0,
        n_train: int = 512, *,
        generator: Optional[torch.Generator] = None) -> Tuple[float, float]:
    """Fit a continuous target with a 2-layer block-circulant MLP by plain
    gradient descent, on the generator's device.

    Returns (initial_mse, final_mse) on held-out points of the unit cube.
    The points come from ``numpy.random.RandomState(seed)``, as in
    ``repro``; the generators from ``generator`` (default: one on the card
    seeded with ``seed``; pass a CPU generator to run on the CPU)."""
    if generator is None:
        generator = torch.Generator(
            device=resolve_device(None)).manual_seed(seed)
    device = torch.device(generator.device)
    rng = np.random.RandomState(seed)
    Xn = rng.uniform(-1, 1, size=(n_train, n_in))
    Xten = rng.uniform(-1, 1, size=(256, n_in))
    f32 = dict(dtype=torch.float32, device=device)
    X, Xte = torch.as_tensor(Xn, **f32), torch.as_tensor(Xten, **f32)
    Y = torch.as_tensor(target(Xn.astype(np.float32)), **f32).reshape(-1, 1)
    Yte = torch.as_tensor(target(Xten.astype(np.float32)),
                          **f32).reshape(-1, 1)

    params = {
        "w1": cc.init_block_circulant(n_in, width, min(k, n_in),
                                      generator=generator, device=device),
        "b1": torch.zeros((width,), **f32),
        "w2": cc.init_block_circulant(width, k, k, generator=generator,
                                      device=device),   # out: first of k
        "b2": torch.zeros((1,), **f32),
    }
    for p in params.values():
        p.requires_grad_(True)

    def mse(x, y):
        h = torch.tanh(cc.bc_matmul_fft(x, params["w1"], width)
                       + params["b1"])
        out = cc.bc_matmul_fft(h, params["w2"], 1) + params["b2"]
        return torch.mean((out - y) ** 2)

    with torch.no_grad():
        init_err = float(mse(Xte, Yte))
    for _ in range(steps):
        grads = torch.autograd.grad(mse(X, Y), list(params.values()))
        with torch.no_grad():
            for p, g in zip(params.values(), grads):
                p -= lr * g
    with torch.no_grad():
        return init_err, float(mse(Xte, Yte))
