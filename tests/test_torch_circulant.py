"""The port's block-circulant serve path against ``repro``'s: DFT matrices,
spectral planes, the spectral and direct lowerings, and the plain version
of the fused kernel against the Pallas kernel in interpret mode.

Inputs are drawn with numpy from a seed and fed to both packages.  Float32
throughout: the two frameworks sum in different orders, so values agree to
a few float32 ulps of the output's scale; the tolerances below allow 1e-5
relative (planes) and 1e-4 of the output scale (whole linears, whose sums
run over a few hundred terms).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import circulant as jcc  # noqa: E402
from repro.kernels import bc_fused as jbf  # noqa: E402
from repro_torch.core import circulant as tcc  # noqa: E402
from repro_torch.kernels import bc_fused as tbf  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

SHAPES = [  # (k, n_in, n_out): n_in and n_out not multiples of k
    (16, 200, 72),
    (128, 300, 200),
]


def _case(k, n_in, n_out, lead=(3, 5), seed=0):
    rng = np.random.RandomState(seed)
    p, q = -(-n_out // k), -(-n_in // k)
    w = (rng.randn(p, q, k) / np.sqrt(n_in)).astype(np.float32)
    x = rng.randn(*lead, n_in).astype(np.float32)
    return w, x


def _tol(ref):
    return 1e-4 * max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("k", [9, 16, 128])
def test_dft_mats_equal(k):
    for mine, theirs in zip(tcc.dft_mats(k), jcc.dft_mats(k)):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))


def test_materialize_dense_equal():
    w, _ = _case(16, 40, 24)
    got = tcc.materialize_dense(torch.from_numpy(w), 24, 40).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jcc.materialize_dense(jnp.asarray(w), 24, 40)))


@pytest.mark.parametrize("k,n_in,n_out", SHAPES)
def test_spectral_cache_planes_agree(k, n_in, n_out):
    w, _ = _case(k, n_in, n_out)
    mine = tcc.spectral_cache(torch.from_numpy(w))
    theirs = jcc.spectral_cache(jnp.asarray(w))
    assert set(mine) == set(theirs) == {"wr", "wi", "ws1", "ws2"}
    for name in mine:
        ref = np.asarray(theirs[name])
        np.testing.assert_allclose(mine[name].numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("k,n_in,n_out", SHAPES)
def test_spectral_and_direct_match_repro(k, n_in, n_out):
    w, x = _case(k, n_in, n_out)
    tw, tx = torch.from_numpy(w), torch.from_numpy(x)
    ref = np.asarray(jcc.bc_matmul_spectral(
        jnp.asarray(x), jcc.spectral_cache(jnp.asarray(w)), k, n_out))
    direct = np.asarray(jcc.bc_matmul_direct(jnp.asarray(x), jnp.asarray(w),
                                             n_out))
    tol = _tol(ref)
    cache = tcc.spectral_cache(tw)
    spectral = tcc.bc_matmul_spectral(tx, cache, k, n_out).numpy()
    assert spectral.shape == (3, 5, n_out)
    np.testing.assert_allclose(spectral, ref, rtol=0, atol=tol)
    np.testing.assert_allclose(spectral, direct, rtol=0, atol=tol)
    np.testing.assert_allclose(tcc.bc_matmul_direct(tx, tw, n_out).numpy(),
                               direct, rtol=0, atol=tol)
    # the serve path (ops.bc_linear -> the fused kernel's plain version)
    np.testing.assert_allclose(tops.bc_linear(tx, cache, k, n_out).numpy(),
                               ref, rtol=0, atol=tol)


@pytest.mark.parametrize("k,n_in,n_out", SHAPES)
def test_fused_plain_matches_pallas_interpret(k, n_in, n_out):
    w, x = _case(k, n_in, n_out, lead=(6,))
    ref = np.asarray(jbf.bc_linear_fused_kernel(
        jnp.asarray(x), jnp.asarray(w), n_out, interpret=True, block_b=4,
        block_p=2))
    cache = tcc.spectral_cache(torch.from_numpy(w))
    got = tops.bc_linear(torch.from_numpy(x), cache, k, n_out).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=_tol(ref))
    # and the kernel-level function on blockified input
    q = w.shape[1]
    xb = np.pad(x, ((0, 0), (0, q * k - n_in))).reshape(-1, q, k)
    jc = jcc.spectral_cache(jnp.asarray(w))
    ref_b = np.asarray(jbf.bc_fused_matmul(
        jnp.asarray(xb), jc["wr"], jc["ws1"], jc["ws2"], k=k, block_b=4,
        block_p=2, interpret=True))
    got_b = tbf.bc_fused_matmul(torch.from_numpy(xb), cache["wr"],
                                cache["ws1"], cache["ws2"], k).numpy()
    np.testing.assert_allclose(got_b, ref_b, rtol=0, atol=_tol(ref_b))


def test_apply_linear_bf16_casts_like_repro():
    """bf16 activations: cast to f32 before blockifying, back after."""
    k, n_in, n_out = 16, 64, 48
    w, x = _case(k, n_in, n_out, lead=(4,))
    spec_j = jcc.LinearSpec("block_circulant", k)
    spec_t = tcc.LinearSpec("block_circulant", k)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    ref = jcc.apply_linear({"wc": jnp.asarray(w)}, jx, spec_j, n_out,
                           mode="serve")
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).bfloat16()
    got = tcc.apply_linear({"wc": torch.from_numpy(w)}, tx, spec_t, n_out,
                           mode="serve")
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    ref32 = np.asarray(ref.astype(jnp.float32))
    # one rounding to bf16 on each side of float32 values that agree to
    # ~1e-6: at most one bf16 step (2^-8 relative) apart
    np.testing.assert_allclose(got.float().numpy(), ref32, rtol=0,
                               atol=2.0 ** -7 * np.abs(ref32).max())


def test_training_path_raises():
    """The training path is ported (it raised before): train mode runs the
    fft lowering with a backward, on the same values as the serve
    lowering (1e-5 of the output's scale), and ignores baked planes."""
    spec = tcc.LinearSpec("block_circulant", 16)
    w, x = _case(16, 32, 32, lead=(2,))
    wt = torch.from_numpy(w).requires_grad_()
    params = {"wc": wt, "wc_cache": {n: torch.zeros_like(t) for n, t in
                                     tcc.spectral_cache(wt.detach()).items()}}
    got = tcc.apply_linear(params, torch.from_numpy(x), spec, 32,
                           mode="train")
    assert got.grad_fn is not None
    ref = tcc.apply_linear({"wc": wt.detach()}, torch.from_numpy(x), spec,
                           32, mode="serve")
    np.testing.assert_allclose(got.detach().numpy(), ref.numpy(), rtol=0,
                               atol=1e-5 * float(ref.abs().max()))
