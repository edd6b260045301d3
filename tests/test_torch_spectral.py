"""The port's ``spectral_matmul`` (its plain version, on the CPU) and the
``kernel_fn`` hook of ``bc_matmul_spectral`` against ``repro``'s, on the
same numpy-seeded inputs.

``repro``'s Pallas kernel runs in interpret mode, as its own tests run it.
Tolerance: 1e-5 of the output's scale; both sides contract the same float32
values, in another order.  The hook is held at Q != P as well (16 x 44,
44 x 16, 16 x 2), where a transposed layout would give wrong numbers, and
its skip rule (quantized caches never reach it) is counted in both
packages.

``spectral_matmul`` reads its operands through their strides in two
layouts: ``repro``'s contiguous one and the views the hook passes
(bin-minor: X (F, B, Q) with strides (1, Q F, F), W (F, Q, P) with
strides (1, F, Q F)), the result in X's layout.  The hook hands it views
of its inputs' storage and returns views of its outputs (no copy either
way, checked by storage pointers); every other layout raises.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import circulant as jcc  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import spectral_matmul as jsm  # noqa: E402
from repro.quant import codec as jq  # noqa: E402
from repro_torch.core import circulant as tcc  # noqa: E402
from repro_torch.kernels import bc_fused as tbf  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import spectral_matmul as tsm  # noqa: E402
from repro_torch.quant import codec as tq  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    tol = rel * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol)


def _planes(rng, F, B, Q, P):
    xr, xi = (rng.randn(F, B, Q).astype(np.float32) for _ in range(2))
    wr, wi = (rng.randn(F, Q, P).astype(np.float32) for _ in range(2))
    return xr, xi, wr, wi - wr, wr + wi


# repro's sweep (tests/test_kernels.py) and the smoke tinyllama's
# projections (k = 16, kf = 9: q/o and k/v 8 x 8, up/gate 8 x 16, down
# 16 x 8) at 24 rows
@pytest.mark.parametrize("F,B,Q,P", [
    (9, 4, 3, 5), (65, 8, 16, 16), (5, 130, 2, 140), (33, 16, 44, 16),
    (9, 24, 8, 8), (9, 24, 8, 16), (9, 24, 16, 8)])
def test_spectral_matmul_plain_matches_repro(F, B, Q, P):
    rng = np.random.RandomState(F * 1000 + B + Q + P)
    xr, xi, wr, ws1, ws2 = _planes(rng, F, B, Q, P)
    before = tsm.KERNEL.launches
    yr, yi = tsm.spectral_matmul(*map(_t, (xr, xi, wr, ws1, ws2)))
    assert tsm.KERNEL.launches == before          # the plain version ran
    assert yr.shape == yi.shape == (F, B, P) and yr.dtype == torch.float32
    kr, ki = jsm.spectral_matmul(*map(jnp.asarray, (xr, xi, wr, ws1, ws2)),
                                 block_b=64, block_p=64, interpret=True)
    rr, ri = jref.spectral_matmul_ref(*map(jnp.asarray, (xr, xi, wr)),
                                      jnp.asarray(ws1 + wr))
    for got, want in ((yr, kr), (yi, ki), (yr, rr), (yi, ri)):
        _close(got.numpy(), want)


def _repro_hook(calls):
    """repro's interpret-mode kernel behind the kernel_fn contract: planes
    (..., q, kf) in, (..., p, kf) out (a test-side adapter; repro ships
    none)."""
    def hook(xr, xi, cache):
        calls.append(1)
        p, q, kf = cache["wr"].shape
        lead = xr.shape[:-2]
        xs = [t.reshape(-1, q, kf).transpose(2, 0, 1) for t in (xr, xi)]
        ws = [cache[n].transpose(2, 1, 0) for n in ("wr", "ws1", "ws2")]
        yr, yi = jsm.spectral_matmul(*xs, *ws, interpret=True)
        return tuple(t.transpose(1, 2, 0).reshape(*lead, p, kf)
                     for t in (yr, yi))
    return hook


def _counting(calls, fn):
    def hook(xr, xi, cache):
        calls.append(1)
        return fn(xr, xi, cache)
    return hook


# (k, n_in, n_out): ragged widths at the smoke block size, and the
# full-width block size at (q, p) = (16, 44), (44, 16) and (16, 2)
@pytest.mark.parametrize("k,n_in,n_out", [
    (16, 200, 72), (128, 2048, 5632), (128, 5632, 2048), (128, 2048, 256)])
def test_hooked_bc_matmul_spectral_matches_repro(k, n_in, n_out):
    rng = np.random.RandomState(n_in + n_out)
    p, q = -(-n_out // k), -(-n_in // k)
    w = (rng.randn(p, q, k) / np.sqrt(n_in)).astype(np.float32)
    x = rng.randn(2, 3, n_in).astype(np.float32)
    jcache = jcc.spectral_cache(jnp.asarray(w))
    tcache = {n: _t(v) for n, v in jcache.items()}
    jcalls, tcalls = [], []
    want = jcc.bc_matmul_spectral(jnp.asarray(x), jcache, k, n_out, True,
                                  _repro_hook(jcalls))
    got = tcc.bc_matmul_spectral(_t(x), tcache, k, n_out, True,
                                 _counting(tcalls, tops.spectral_contract))
    assert jcalls == tcalls == [1]
    assert got.shape == (2, 3, n_out)
    _close(got.numpy(), want)
    # the same projection through apply_linear with the hook, and without
    # it (the fused kernel's plain version): one function, three lowerings
    params = {"wc_cache": tcache}
    spec = tcc.LinearSpec("block_circulant", k)
    hooked = tcc.apply_linear(params, _t(x), spec, n_out,
                              kernel_fn=_counting(tcalls,
                                                  tops.spectral_contract))
    fused = tcc.apply_linear(params, _t(x), spec, n_out)
    assert tcalls == [1, 1]
    _close(hooked.numpy(), want)
    _close(fused.numpy(), want)


def test_spectral_contract_layout_and_refusals():
    """(..., q, kf) planes in, (..., p, kf) out, against the einsum it
    replaces; a cache without the Gauss planes is refused by name."""
    rng = np.random.RandomState(7)
    p, q, kf = 3, 5, 9
    cache = {n: _t(rng.randn(p, q, kf).astype(np.float32))
             for n in ("wr", "wi")}
    cache["ws1"] = cache["wi"] - cache["wr"]
    cache["ws2"] = cache["wr"] + cache["wi"]
    xr, xi = (_t(rng.randn(2, 4, q, kf).astype(np.float32))
              for _ in range(2))
    yr, yi = tops.spectral_contract(xr, xi, cache)
    wr, wi = tcc._gauss_contract(xr, xi, cache, "...qf,pqf->...pf")
    assert yr.shape == (2, 4, p, kf)
    _close(yr.numpy(), wr.numpy())
    _close(yi.numpy(), wi.numpy())
    with pytest.raises(ValueError, match="ws1"):
        tops.spectral_contract(xr, xi, {"wr": cache["wr"],
                                         "wi": cache["wi"]})


@pytest.mark.parametrize("bits", [8, 4])
def test_hook_skipped_for_quantized_caches_in_both_packages(bits):
    """repro's rule: a quantized cache keeps the scale-folding einsum and
    never calls kernel_fn.  The port's apply_linear sends it to the fused
    kernel's quantized lane instead (here its plain version)."""
    rng = np.random.RandomState(bits)
    k, n_in, n_out = 16, 200, 72
    p, q = -(-n_out // k), -(-n_in // k)
    w = (rng.randn(p, q, k) / np.sqrt(n_in)).astype(np.float32)
    x = rng.randn(3, n_in).astype(np.float32)
    jcache = jq.quantize_plane_cache(jcc.spectral_cache(jnp.asarray(w)),
                                     bits)
    tcache = {n: _t(v) for n, v in jcache.items()}
    jcalls, tcalls = [], []
    want = jcc.bc_matmul_spectral(jnp.asarray(x), jcache, k, n_out, True,
                                  _repro_hook(jcalls))
    got = tcc.bc_matmul_spectral(_t(x), tcache, k, n_out, True,
                                 _counting(tcalls, tops.spectral_contract))
    spec = tcc.LinearSpec("block_circulant", k)
    before = (tbf.KERNEL.launches, tsm.KERNEL.launches)
    routed = tcc.apply_linear({"wc_cache": tcache}, _t(x), spec, n_out,
                              kernel_fn=_counting(tcalls,
                                                  tops.spectral_contract))
    assert jcalls == tcalls == []
    assert (tbf.KERNEL.launches, tsm.KERNEL.launches) == before
    assert tq.plane_from_cache(tcache, "wr", k // 2 + 1)[1] is not None
    _close(got.numpy(), want)
    _close(routed.numpy(), want)


def _bin_minor(a, perm):
    """A numpy array as the hook passes it: a (strided) torch view of a
    contiguous transpose (``perm`` puts the bin axis last)."""
    inv = np.argsort(perm)
    return torch.from_numpy(np.ascontiguousarray(a.transpose(perm))) \
        .permute(*inv)


@pytest.mark.parametrize("F,B,Q,P", [
    (9, 4, 3, 5), (65, 8, 16, 16), (33, 16, 44, 16), (9, 24, 16, 8),
    (65, 6, 86, 16), (65, 6, 20, 76)])
def test_spectral_matmul_bin_minor_views_match_repro(F, B, Q, P):
    """The hook's layout: X (F, B, Q) with strides (1, Q F, F), W (F, Q, P)
    with strides (1, F, Q F); the result in X's layout, the numbers of
    repro's kernel on contiguous copies."""
    rng = np.random.RandomState(F + B + Q + P)
    planes = _planes(rng, F, B, Q, P)
    xr, xi = (_bin_minor(a, (1, 2, 0)) for a in planes[:2])
    ws = [_bin_minor(a, (2, 1, 0)) for a in planes[2:]]
    assert xr.stride() == (1, Q * F, F) and ws[0].stride() == (1, F, Q * F)
    assert tsm.layout_of(xr, xi, *ws) == tsm.BIN_MINOR
    yr, yi = tsm.spectral_matmul(xr, xi, *ws)
    assert yr.shape == (F, B, P) and yr.stride() == (1, P * F, F)
    kr, ki = jsm.spectral_matmul(*map(jnp.asarray, planes), block_b=64,
                                 block_p=64, interpret=True)
    _close(yr.numpy(), kr)
    _close(yi.numpy(), ki)


def test_spectral_contract_passes_views_without_copies(monkeypatch):
    """spectral_contract hands spectral_matmul views of its inputs' storage
    (no copy in) and returns views of spectral_matmul's outputs (no copy
    out), contiguous (..., p, kf)."""
    rng = np.random.RandomState(3)
    p, q, kf = 3, 5, 9
    cache = {n: _t(rng.randn(p, q, kf).astype(np.float32))
             for n in ("wr", "ws1", "ws2")}
    xr, xi = (_t(rng.randn(2, 4, q, kf).astype(np.float32))
              for _ in range(2))
    seen = {}

    def recording(*args):
        seen["args"] = args
        seen["out"] = tsm.spectral_matmul(*args)
        return seen["out"]

    monkeypatch.setattr(tops, "spectral_matmul", recording)
    yr, yi = tops.spectral_contract(xr, xi, cache)
    inputs = (xr, xi, cache["wr"], cache["ws1"], cache["ws2"])
    for arg, src in zip(seen["args"], inputs):
        assert arg.data_ptr() == src.data_ptr()
        assert arg.untyped_storage().data_ptr() == \
            src.untyped_storage().data_ptr()
    assert seen["args"][0].stride() == (1, q * kf, kf)
    assert seen["args"][2].stride() == (1, kf, q * kf)
    for got, out in zip((yr, yi), seen["out"]):
        assert got.shape == (2, 4, p, kf) and got.is_contiguous()
        assert got.data_ptr() == out.data_ptr()
    want = tcc._gauss_contract(xr, xi, cache, "...qf,pqf->...pf")
    _close(yr.numpy(), want[0].numpy())
    _close(yi.numpy(), want[1].numpy())


def _refused_layouts():
    """name -> (xr, xi, wr, ws1, ws2) in a layout the kernel does not take."""
    rng = np.random.RandomState(5)
    F, B, Q, P = 9, 4, 3, 5
    planes = [_t(a) for a in _planes(rng, F, B, Q, P)]
    minor_x = [_bin_minor(a.numpy(), (1, 2, 0)) for a in planes[:2]]
    minor_w = [_bin_minor(a.numpy(), (2, 1, 0)) for a in planes[2:]]
    wide = _t(rng.randn(F, B, 2 * Q).astype(np.float32))[..., ::2]
    return {
        "no_unit_stride": (wide, wide, *planes[2:]),
        "x_minor_w_major": (*minor_x, *planes[2:]),
        "x_major_w_minor": (*planes[:2], *minor_w),
        "w_transposed": (*planes[:2], *(w.transpose(1, 2).contiguous()
                                        .transpose(1, 2)
                                        for w in planes[2:])),
    }


@pytest.mark.parametrize("name", sorted(_refused_layouts()))
def test_spectral_matmul_refuses_other_layouts(name):
    with pytest.raises(ValueError, match="neither bin-major"):
        tsm.spectral_matmul(*_refused_layouts()[name])


def test_spectral_contract_refuses_strided_spectra():
    """Spectra whose (N, q, kf) rows are not contiguous (the real part of a
    complex FFT) raise; spectral_contract never copies them."""
    rng = np.random.RandomState(6)
    p, q, kf = 3, 5, 9
    cache = {n: _t(rng.randn(p, q, kf).astype(np.float32))
             for n in ("wr", "ws1", "ws2")}
    xc = torch.fft.rfft(_t(rng.randn(4, q, 16).astype(np.float32)), dim=-1)
    with pytest.raises(ValueError, match="neither bin-major"):
        tops.spectral_contract(xc.real, xc.imag, cache)
