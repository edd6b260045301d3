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
from repro_torch.configs.registry import get_config  # noqa: E402
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


# tinyllama-1.1b's training shapes (q/o, k/v, up/gate, down, the fused
# q/k/v and up/gate) at N = 8 x 1,024, a ragged small one, and qwen3-4b's
# up/gate and down and phi-3-vision-4.2b's up/gate (1,520 and 1,536
# pairs: several output tiles, two chunks); want is (chunk, chunks, mt,
# nt, p_tiles, q_tiles, splits)
PLAN_CASES = [
    (8192, 16, 16, 128, (8192, 1, 1, 2, 1, 1, 4)),
    (8192, 2, 16, 128, (8192, 1, 1, 2, 1, 1, 4)),
    (8192, 44, 16, 128, (8192, 1, 3, 2, 1, 1, 4)),
    (8192, 16, 44, 128, (8192, 1, 1, 8, 1, 1, 4)),
    (8192, 20, 16, 128, (8192, 1, 2, 2, 1, 1, 4)),
    (8192, 88, 16, 128, (4096, 2, 3, 2, 2, 1, 2)),
    (37, 3, 5, 16, (128, 1, 1, 1, 1, 1, 2)),
    (8192, 76, 20, 128, (4096, 2, 2, 4, 3, 1, 1)),
    (8192, 20, 76, 128, (4096, 2, 2, 4, 1, 3, 1)),
    (8192, 64, 24, 128, (4096, 2, 2, 4, 2, 1, 2))]


def _split_rows(N, pl):
    """(chunk, split) of every row of N under the kernel's cut
    (csrc/bc_grad_w.cu: a split covers per = ceil(chunk / 64 / splits)
    64-row stages of each chunk)."""
    per = tgw.cdiv(pl.chunk // tgw.ROWS, pl.splits) * tgw.ROWS
    n = np.arange(N)
    return n // pl.chunk, n % pl.chunk // per


@pytest.mark.parametrize("N,p,q,k,want", PLAN_CASES)
def test_bc_grad_w_plan(N, p, q, k, want):
    """The plan at tinyllama's training shapes: the packed slots cover
    every rfft bin once (one contraction block's bins each), the output
    tiles every (i, j) pair; every row sits in exactly one chunk and one
    split, and no split is empty; the DFT's tiles cover a chunk; shared
    memory fits a block (two an SM where the plan counts on it) and the
    contraction's accumulators (8 floats a 16 x 8 tile and lane) fit its
    registers (at most 64 a thread, under the launch bounds' 128)."""
    pl = tgw.plan(N, p, q, k)
    assert (pl.chunk, pl.chunks, pl.mt, pl.nt, pl.p_tiles, pl.q_tiles,
            pl.splits) == want
    # slot 0 holds bins 0 and k/2, slot s bin s (csrc/bc_grad_w.cu); the
    # contraction's grid x is the slots
    slots = [(0, k // 2)] + [(f,) for f in range(1, k // 2)]
    assert sorted(f for slot in slots for f in slot) == list(range(k // 2 + 1))
    assert pl.mac_blocks % len(slots) == 0
    assert pl.chunk % tgw.DFT_ROWS == 0
    assert pl.p_tiles * 16 * pl.mt >= p and pl.q_tiles * 8 * pl.nt >= q
    assert (pl.p_tiles - 1) * 16 * pl.mt < p
    assert (pl.q_tiles - 1) * 8 * pl.nt < q
    assert pl.chunk % tgw.CHUNK_ROWS == 0
    assert (pl.chunks - 1) * pl.chunk < N <= pl.chunks * pl.chunk
    chunk, split = _split_rows(N, pl)
    assert chunk.max() == pl.chunks - 1 and split.max() < pl.splits
    full = _split_rows(pl.chunk, pl)[1]     # a whole chunk uses every split
    assert set(full.tolist()) == set(range(pl.splits))
    assert pl.mac_blocks == k // 2 * pl.p_tiles * pl.q_tiles * pl.splits
    assert max(pl.dft_smem, pl.mac_smem) <= tgw.MAX_SMEM
    assert pl.dft_blocks == tgw.SMS * tgw.per_sm(pl.dft_smem)
    assert pl.mac_blocks <= tgw.SMS * tgw.per_sm(pl.mac_smem) or (
        pl.splits == 1)
    assert pl.nt in tgw.NT_CHOICES and pl.mt * pl.nt <= tgw.MAX_UNITS
    assert pl.spec_floats == k * (p + q) * pl.chunk
    assert pl.part_floats == pl.splits * k // 2 * p * q * 2


@pytest.mark.parametrize("N,p,q,k,why", [
    (64, 2, 2, 0, "block size"), (64, 2, 2, 264, "bins"),
    (64, 8192, 8192, 128, "grid"), (0, 2, 2, 16, "empty")])
def test_bc_grad_w_plan_refuses(N, p, q, k, why):
    """What the kernel cannot run raises ValueError naming the reason:
    a block size below 1 (any other k up to 256 runs: the folded DFT at
    multiples of 8, the plain one else), more than 132 bins, more output
    tiles than a grid's y can hold (8,192 x 8,192 blocks: 256 x 256
    tiles), no rows."""
    with pytest.raises(ValueError, match=why):
        tgw.plan(N, p, q, k)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2.5-3b", "qwen3-4b",
                                  "phi-3-vision-4.2b"])
def test_bc_grad_w_plan_takes_every_trained_shape(arch):
    """Every weight-gradient shape of the archs the port trains, at their
    published widths and N = 8 x 1,024 rows (each projection, and q/k/v
    and up/gate fused), has a plan whose blocks fit shared memory and
    whose spectra scratch stays within its cap."""
    cfg = get_config(arch)
    a, k = cfg.attention, cfg.compression.block_attn
    d, dff = cfg.d_model, cfg.d_ff
    hq, hkv = a.num_heads * a.head_dim, a.num_kv_heads * a.head_dim
    for n_in, n_out in [(d, hq), (d, hkv), (hq, d), (d, dff), (dff, d),
                        (d, hq + 2 * hkv), (d, 2 * dff)]:
        p, q = tcc.num_blocks(n_out, k), tcc.num_blocks(n_in, k)
        pl = tgw.plan(8192, p, q, k)
        assert max(pl.dft_smem, pl.mac_smem) <= tgw.MAX_SMEM
        assert 4 * pl.spec_floats <= tgw.CHUNK_BYTES
        assert pl.p_tiles * 16 * pl.mt >= p and pl.q_tiles * 8 * pl.nt >= q


def _fold_groups(x):
    """A row's folded values as the DFT kernel sorts them in shared memory:
    with h = k/2, s_t = x_t + x_{k-t} and d_t = x_t - x_{k-t} (s_0 = x_0,
    s_h = x_h), the groups (s_t, t = 0, 2, .. h - 2), (s_t, t odd), (d_t,
    t = 2, .. h - 2), (d_t, t odd), each padded to fold_len; and s_h."""
    k = x.shape[-1]
    h, hh = k // 2, k // 4
    t = torch.arange(1, h)
    s = x[..., :h + 1].clone()
    s[..., 1:h] = x[..., 1:h] + x[..., k - t]
    d = x[..., 1:h] - x[..., k - t]
    g = torch.zeros((*x.shape[:-1], 4, tgw.fold_len(k)), dtype=x.dtype)
    g[..., 0, :hh], g[..., 1, :hh] = s[..., 0:h:2], s[..., 1:h:2]
    g[..., 2, :hh - 1], g[..., 3, :hh] = d[..., 1:h - 1:2], d[..., 0:h - 1:2]
    return g, s[..., h]


def _packed_spectra(x):
    """The DFT kernel's arithmetic on rows x (..., k): the four folded
    groups times the four sub-panels (``dft_panel``), then the butterflies
    into packed columns (cosine: Xr_f = E + O with E's (-1)^f s_h term,
    Xr_{h-f} = E - O; sine: Xi_f = E + O, Xi_{h-f} = O - E; row 0 of the
    sine pair is bin h/2's sine part), and bin h/2's cosine part as the
    alternating sum of the even group and s_h."""
    k = x.shape[-1]
    h, hh = k // 2, k // 4
    F = tgw.dft_panel(k, "cpu").double()
    g, sh = _fold_groups(x)
    e, o, es, os_ = (g[..., i, :] @ F[i].T for i in range(4))
    sign = torch.tensor([(-1.0) ** f for f in range(F.shape[1])],
                        dtype=x.dtype)
    e = e + sign * sh[..., None]
    out = torch.zeros((*x.shape[:-1], k), dtype=x.dtype)
    for f in range(hh):
        out[..., 2 * f if f else 0] = e[..., f] + o[..., f]
        out[..., 2 * (h - f) if f else 1] = e[..., f] - o[..., f]
        if f:
            out[..., 2 * f + 1] = es[..., f] + os_[..., f]
            out[..., 2 * (h - f) + 1] = os_[..., f] - es[..., f]
    out[..., h + 1] = os_[..., 0] + es[..., 0]
    out[..., h] = (g[..., 0, :hh] * sign[:hh]).sum(-1) + (-1.0) ** hh * sh
    return out


def _staged(gy, xb, k, pl):
    """The kernel's decomposition in plain PyTorch, float64: per chunk of
    rows (padded with zero rows to 128) the packed spectra
    (``_packed_spectra``, stored (k, p + q, rows) as the scratch holds
    them); per split of the chunk and slot, Ur = Gr Xr^T + Gi Xi^T and Ui
    = Gi Xr^T - Gr Xi^T (slot 0: bin 0's Gr Xr^T and bin k/2's Gi Xi^T),
    written by the first chunk and added by the later ones; the splits
    summed in split order, weighted by 1/k (columns 0 and 1) or 2/k, times
    P (``packed_panel_t``)."""
    N, p, _ = gy.shape
    q = xb.shape[1]
    slots, rows = k // 2, tgw.ROWS
    P = tgw.packed_panel_t(k, "cpu").double()
    per = tgw.cdiv(pl.chunk // rows, pl.splits) * rows
    part = torch.zeros((pl.splits, slots, p * q, 2), dtype=torch.float64)
    for n0 in range(0, N, pl.chunk):
        nc = min(pl.chunk, N - n0)
        raw = torch.zeros((tgw.cdiv(nc, tgw.CHUNK_ROWS) * tgw.CHUNK_ROWS,
                           p + q, k), dtype=torch.float64)
        raw[:nc, :p], raw[:nc, p:] = gy[n0:n0 + nc], xb[n0:n0 + nc]
        spec = _packed_spectra(raw).permute(2, 1, 0)
        for z in range(pl.splits):
            s = spec[:, :, z * per:(z + 1) * per]
            gr, gi = s[0::2, :p], s[1::2, :p]
            xr, xi = s[0::2, p:], s[1::2, p:]
            mm = lambda a, b: torch.einsum("spn,sqn->spq", a, b)  # noqa
            ur = mm(gr, xr) + mm(gi, xi)
            ui = mm(gi, xr) - mm(gr, xi)
            ur[0], ui[0] = mm(gr[:1], xr[:1])[0], mm(gi[:1], xi[:1])[0]
            val = torch.stack([ur, ui], -1).reshape(slots, p * q, 2)
            part[z] = val if n0 == 0 else part[z] + val
    u = part[0]
    for z in range(1, pl.splits):
        u = u + part[z]
    u = u.permute(1, 0, 2).reshape(p * q, k)
    w = torch.full((k,), 2.0 / k, dtype=torch.float64)
    w[:2] = 1.0 / k
    return ((u * w) @ P).reshape(p, q, k)


@pytest.mark.parametrize("k", [8, 16, 24, 40, 128, 200, 256])
def test_bc_grad_w_folded_dft_is_the_packed_dft(k):
    """The DFT kernel's folded arithmetic (two folds, four sub-panels,
    butterflies) gives the packed spectra ``x @ P^T`` of the packed real
    DFT, at every kind of k: k/4 odd or even, not a multiple of 16, and
    the largest."""
    x = torch.from_numpy(np.random.RandomState(k).randn(7, k))
    ref = x @ tgw.packed_panel_t(k, "cpu").double().T
    _close(_packed_spectra(x).numpy(), ref.numpy(), 1e-5)


@pytest.mark.parametrize("N,p,q,k,chunk", [
    (37, 3, 5, 16, None), (130, 2, 7, 24, 128), (200, 5, 3, 8, 128),
    (300, 4, 6, 40, 128), (96, 1, 1, 16, None)])
def test_bc_grad_w_decomposition_matches_repro(N, p, q, k, chunk):
    """The kernel's decomposition (``_staged``: packed slots, chunks, row
    splits, partials added in split order) against ``bc_grad_w_plain`` and
    against ``repro``'s ``gw`` through ``jax.vjp`` of its block-circulant
    core, on ragged shapes; ``chunk`` forces several chunks at a small N
    (the last one short) through ``plan``'s ``chunk``."""
    rng = np.random.RandomState(3)
    xb = rng.randn(N, q, k).astype(np.float32)
    w = (rng.randn(p, q, k) / np.sqrt(q * k)).astype(np.float32)
    gy = rng.randn(N, p, k).astype(np.float32)
    pl = tgw.plan(N, p, q, k, chunk)
    got = _staged(torch.from_numpy(gy).double(),
                  torch.from_numpy(xb).double(), k, pl)
    _close(got.numpy(), tgw.bc_grad_w_plain(
        torch.from_numpy(gy), torch.from_numpy(xb), k).numpy(), 1e-4)
    _, vjp = jax.vjp(lambda v: jcc._bc_fft_core(jnp.asarray(xb), v, True),
                     jnp.asarray(w))
    _close(got.numpy(), vjp(jnp.asarray(gy))[0], 1e-4)
