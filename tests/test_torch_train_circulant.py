"""The port's block-circulant training path against ``repro``'s: the output
and both gradients of ``bc_matmul_fft`` and ``bc_matmul_fused(mode=
"train")`` through ``jax.vjp`` (``repro``'s hand-derived backward), the
weight gradient's plain version against ``repro``'s ``gw``, the adjoint
planes, and ``gradcheck`` of the plain autograd Function.

Inputs come from numpy with a seed.  Float32 sums run in other orders in
the two frameworks: outputs and input gradients are held at 1e-5 of their
scale (sums of a few hundred terms), weight gradients (sums over every
row) at 1e-4 of theirs.  The adjoint planes are exact sign flips of
transposes and are held bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import circulant as jcc  # noqa: E402
from repro_torch.core import circulant as tcc  # noqa: E402
from repro_torch.kernels import bc_grad_w as tgw  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

# (k, n_in, n_outs, lead): n_in and n_out not multiples of k, leading axes
CASES = [(16, 40, (56,), (3, 5)), (32, 72, (40, 24, 24), (2, 3, 4))]


def _case(k, n_in, n_outs, lead, seed=0):
    rng = np.random.RandomState(seed)
    q = -(-n_in // k)
    ws = [(rng.randn(-(-n // k), q, k) / np.sqrt(n_in)).astype(np.float32)
          for n in n_outs]
    x = rng.randn(*lead, n_in).astype(np.float32)
    gs = [rng.randn(*lead, n).astype(np.float32) for n in n_outs]
    return ws, x, gs


def _close(got, ref, rel):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=rel * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("gauss", [True, False])
@pytest.mark.parametrize("k,n_in,n_outs,lead", CASES)
def test_bc_matmul_fft_and_fused_grads_match_repro(k, n_in, n_outs, lead,
                                                   gauss):
    """One projection through ``bc_matmul_fft`` (the first generator) and
    all of them through ``bc_matmul_fused(mode="train")``: outputs, the
    input's gradient and every generator's, against ``jax.vjp``."""
    ws, x, gs = _case(k, n_in, n_outs, lead)

    def jfused(x, *ws):
        return tuple(jcc.bc_matmul_fused(x, list(ws), list(n_outs), "train",
                                         gauss=gauss))

    def jsingle(x, w):
        return jcc.bc_matmul_fft(x, w, n_outs[0], gauss)

    for jfn, tfn, nw, cot in (
            (jsingle, lambda x, w: [tcc.bc_matmul_fft(x, w, n_outs[0],
                                                      gauss)], 1, gs[:1]),
            (jfused, lambda x, *w: tcc.bc_matmul_fused(
                x, list(w), list(n_outs), "train", gauss=gauss),
             len(ws), gs)):
        jargs = [jnp.asarray(x)] + [jnp.asarray(w) for w in ws[:nw]]
        jout, vjp = jax.vjp(jfn, *jargs)
        fused = isinstance(jout, tuple)
        jout = jout if fused else (jout,)
        jgrads = vjp(tuple(jnp.asarray(g) for g in cot) if fused
                     else jnp.asarray(cot[0]))
        targs = [torch.from_numpy(a).requires_grad_()
                 for a in [x] + ws[:nw]]
        touts = tfn(*targs)
        torch.autograd.backward(touts, [torch.from_numpy(g) for g in cot])
        for got, ref in zip(touts, jout):
            _close(got.detach().numpy(), ref, 1e-5)
        _close(targs[0].grad.numpy(), jgrads[0], 1e-5)
        for t, j in zip(targs[1:], jgrads[1:]):
            _close(t.grad.numpy(), j, 1e-4)


@pytest.mark.parametrize("gauss", [True, False])
@pytest.mark.parametrize("N,p,q,k", [(37, 3, 5, 16), (64, 2, 4, 32)])
def test_backward_halves_match_repro_bwd(N, p, q, k, gauss):
    """``bc_grad_w_plain`` against the ``gw`` of ``repro``'s
    ``_bc_fft_bwd`` and ``bc_adjoint`` against its ``gx``, on blockified
    inputs."""
    rng = np.random.RandomState(1)
    xb = rng.randn(N, q, k).astype(np.float32)
    w = (rng.randn(p, q, k) / np.sqrt(q * k)).astype(np.float32)
    gy = rng.randn(N, p, k).astype(np.float32)
    jgx, jgw = jcc._bc_fft_bwd(gauss, (jnp.asarray(xb), jnp.asarray(w)),
                               jnp.asarray(gy))
    tx, tw, tg = (torch.from_numpy(a) for a in (xb, w, gy))
    _close(tgw.bc_grad_w_plain(tg, tx, k).numpy(), jgw, 1e-4)
    _close(tops.bc_adjoint(tg, tw, gauss).numpy(), jgx, 1e-5)


def test_adjoint_planes_are_exact_sign_flips():
    """W^H's Gauss planes from W's: wr' = wr^T, ws1' = -ws2^T, ws2' =
    -ws1^T, bit for bit; and they are the Gauss planes of (wr, -wi)
    transposed, the values ``repro``'s backward contracts with."""
    rng = np.random.RandomState(2)
    w = torch.from_numpy(rng.randn(3, 5, 16).astype(np.float32))
    c = tcc.spectral_cache(w)
    a = tops.adjoint_planes(c)
    t = lambda m: m.transpose(0, 1)  # noqa: E731
    assert set(a) == {"wr", "ws1", "ws2"}
    assert all(a[n].is_contiguous() and a[n].shape == (5, 3, 9) for n in a)
    assert torch.equal(a["wr"], t(c["wr"]))
    assert torch.equal(tops.adjoint_planes(tcc.spectral_cache(w, False))[
        "wi"], t(-c["wi"]))
    assert torch.equal(a["ws1"], t(-c["ws2"]))
    assert torch.equal(a["ws2"], t(-c["ws1"]))
    # repro's planes for conj(W): ws1 = (-wi) - wr, ws2 = wr + (-wi)
    assert torch.equal(a["ws1"], t(-c["wi"] - c["wr"]))
    assert torch.equal(a["ws2"], t(c["wr"] + -c["wi"]))


@pytest.mark.parametrize("gauss", [True, False])
def test_plain_function_passes_gradcheck(gauss):
    """The autograd Function's backward (adjoint and weight gradient, the
    plain versions) against finite differences in float64."""
    gen = torch.Generator().manual_seed(0)
    xb = torch.randn(5, 3, 16, dtype=torch.float64, generator=gen,
                     requires_grad=True)
    w = torch.randn(2, 3, 16, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a, b: tcc.BCMatmulFFT.apply(a, b, gauss), (xb, w))


@pytest.mark.parametrize("N,p,q,k,want", [
    (8192, 16, 16, 128, (8, 8, 33, 252)), (8192, 2, 16, 128, (2, 16, 128, 64)),
    (8192, 44, 16, 128, (8, 8, 11, 748)), (8192, 16, 44, 128, (8, 8, 11, 748)),
    (8192, 20, 16, 128, (7, 9, 22, 376)), (8192, 88, 16, 128, (8, 8, 6, 1368)),
    (37, 3, 5, 16, (3, 5, 10, 4))])
def test_bc_grad_w_plan(N, p, q, k, want):
    """The kernel's tiles and row splits at tinyllama's training shapes:
    at most 64 pairs a tile, every row in exactly one split (the last one
    not empty), at most one block an SM, shared memory within a block's."""
    pl = tgw.plan(N, p, q, k)
    assert (pl.pt, pl.qt, pl.splits, pl.rows) == want
    assert pl.pt * pl.qt <= tgw.MAX_PAIRS and pl.rows % tgw.ROWS == 0
    assert (pl.splits - 1) * pl.rows < N <= pl.splits * pl.rows
    assert pl.blocks <= tgw.SMS and pl.smem_bytes <= tgw.MAX_SMEM
