"""The paper's block-circulant CONV layers and their accounting in the
port (``core/conv.py``, ``core/compression.py``, ``core/theory.py``, the
accounting helpers of ``core/circulant.py``) against ``repro``'s on the
same inputs: ``im2col`` bit for bit, the layer on both paths and its
gradients within 1e-5 of their scale, ``summarize`` on the paper's model
inventories, the displacement-rank certificates, and the universal
approximation demo's contract."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import CompressionConfig as JComp  # noqa: E402
from repro.core import circulant as jcc  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.core import conv as jconv  # noqa: E402
from repro.core import theory as jtheory  # noqa: E402
from repro_torch.configs.base import CompressionConfig as TComp  # noqa: E402
from repro_torch.core import circulant as tcc  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.core import conv as tconv  # noqa: E402
from repro_torch.core import theory as ttheory  # noqa: E402

TOL = 1e-5          # of the output's scale: float32 sums in another order


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * scale, (err, tol * scale)


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ---------------------------------------------------------------------------
# im2col and the layer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("r,stride,padding,shape", [
    (3, 1, "VALID", (2, 8, 8, 3)),
    (3, 1, "SAME", (2, 7, 9, 4)),
    (3, 2, "SAME", (1, 9, 8, 5)),
    (5, 2, "VALID", (2, 11, 10, 2)),
    (1, 1, "SAME", (2, 4, 4, 6)),
])
def test_im2col_bit_for_bit(r, stride, padding, shape):
    x = _x(shape)
    want = np.asarray(jconv.im2col(jnp.asarray(x), r, stride, padding))
    got = tconv.im2col(torch.from_numpy(x), r, stride, padding).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _layer(r, C, P, k, seed=0):
    w = np.asarray(jconv.init_conv_circulant(jax.random.PRNGKey(seed), r, C,
                                             P, k))
    return w, torch.from_numpy(w.copy())


CONV_CASES = [
    # r, C, P, k, input, stride, padding
    (3, 4, 8, 4, (2, 6, 6, 4), 1, "VALID"),
    (3, 8, 16, 8, (2, 6, 5, 8), 1, "SAME"),
    (3, 5, 12, 8, (1, 7, 7, 5), 2, "SAME"),     # r²C = 45: padded blocks
    (1, 16, 16, 16, (2, 4, 4, 16), 1, "VALID"),
]


@pytest.mark.parametrize("path", ["fft", "direct"])
@pytest.mark.parametrize("case", CONV_CASES)
def test_conv_matches_repro(case, path):
    r, C, P, k, shape, stride, padding = case
    wj, wt = _layer(r, C, P, k)
    x = _x(shape, 1)
    want = jconv.conv2d_block_circulant(jnp.asarray(x), jnp.asarray(wj), r,
                                        P, stride, padding, path)
    got = tconv.conv2d_block_circulant(torch.from_numpy(x), wt, r, P,
                                       stride, padding, path)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got.numpy(), want)


@pytest.mark.parametrize("case", CONV_CASES)
def test_conv_grads_match_jax_grad(case):
    """dL/dx and dL/dw of the fft path (the paper's hand-derived backward
    through BCMatmulFFT) against ``jax.grad`` of ``repro``'s layer."""
    r, C, P, k, shape, stride, padding = case
    wj, wt = _layer(r, C, P, k, seed=2)
    x = _x(shape, 3)
    y_shape = jconv.conv2d_block_circulant(jnp.asarray(x), jnp.asarray(wj),
                                           r, P, stride, padding).shape
    ct = _x(y_shape, 4)

    def loss(xx, ww):
        y = jconv.conv2d_block_circulant(xx, ww, r, P, stride, padding)
        return jnp.sum(y * ct)
    gx_want, gw_want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x),
                                                      jnp.asarray(wj))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt.requires_grad_(True)
    y = tconv.conv2d_block_circulant(xt, wt, r, P, stride, padding)
    (y * torch.from_numpy(ct)).sum().backward()
    _close(xt.grad.numpy(), gx_want)
    _close(wt.grad.numpy(), gw_want)


def test_conv_equals_materialized_dense():
    """The paper's claim that im2col'd F is block-circulant: the circulant
    layer equals ``F.conv2d`` with the materialized filter."""
    r, C, P, k = 3, 4, 8, 4
    gen = torch.Generator().manual_seed(0)
    w = tconv.init_conv_circulant(r, C, P, k, generator=gen, device="cpu")
    x = torch.from_numpy(_x((2, 6, 6, C), 1))
    out = tconv.conv2d_block_circulant(x, w, r, P)
    dense = tcc.materialize_dense(w, tcc.num_blocks(P, k) * k,
                                  tcc.num_blocks(r * r * C, k) * k)
    f = dense[:P, :r * r * C].T.reshape(r, r, C, P)
    ref = tconv.conv2d_dense(x, f)
    _close(out.numpy(), ref.numpy())
    # and the dense reference is repro's on the same filter
    _close(ref.numpy(), jconv.conv2d_dense(jnp.asarray(x.numpy()),
                                           jnp.asarray(f.numpy())))


def test_conv_block_size_not_multiple_of_8_runs_plain_on_cpu():
    """A block size below 8 (k = 4 here; the card's kernels pad its DFT
    panel to 8) runs on the CPU, where the wrappers take their plain
    versions."""
    r, C, P, k = 3, 2, 4, 4
    gen = torch.Generator().manual_seed(1)
    w = tconv.init_conv_circulant(r, C, P, k, generator=gen,
                                  device="cpu").requires_grad_(True)
    x = torch.from_numpy(_x((1, 5, 5, C), 2))
    tconv.conv2d_block_circulant(x, w, r, P).pow(2).sum().backward()
    assert w.grad.shape == w.shape and float(w.grad.abs().sum()) > 0


def test_conv_padding_refused():
    with pytest.raises(ValueError, match="padding"):
        tconv.im2col(torch.zeros((1, 4, 4, 1)), 3, padding="FULL")


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------
# benchmarks/common.py:PAPER_MODELS, as (name, class, n_in, n_out, count)
PAPER_MODELS = {
    "mnist_mlp1": [("fc1", "ffn", 256, 256, 1), ("fc2", "ffn", 256, 128, 1),
                   ("out", "other", 128, 10, 1)],
    "mnist_mlp2": [("fc1", "ffn", 128, 128, 1), ("fc2", "ffn", 128, 128, 1),
                   ("out", "other", 128, 10, 1)],
    "mnist_cnn": [("conv1", "attn", 25, 6, 24 * 24),
                  ("conv2", "attn", 25 * 6, 16, 8 * 8),
                  ("fc1", "ffn", 400, 120, 1), ("fc2", "ffn", 120, 84, 1),
                  ("out", "other", 84, 10, 1)],
    "svhn_cnn": [("conv1", "attn", 27, 32, 32 * 32),
                 ("conv2", "attn", 288, 32, 16 * 16),
                 ("conv3", "attn", 288, 64, 8 * 8),
                 ("fc1", "ffn", 1024, 256, 1), ("out", "other", 256, 10, 1)],
    "cifar_cnn1": [("conv1", "attn", 27, 64, 32 * 32),
                   ("conv2", "attn", 576, 64, 16 * 16),
                   ("conv3", "attn", 576, 128, 8 * 8),
                   ("fc1", "ffn", 2048, 512, 1),
                   ("out", "other", 512, 10, 1)],
    "cifar_wrn": [("g1", "attn", 9 * 160, 160, 32 * 32 * 8),
                  ("g2", "attn", 9 * 320, 320, 16 * 16 * 8),
                  ("g3", "attn", 9 * 640, 640, 8 * 8 * 8),
                  ("out", "other", 640, 10, 1)],
}


@pytest.mark.parametrize("gauss", [True, False])
@pytest.mark.parametrize("block", [16, 64])
@pytest.mark.parametrize("model", sorted(PAPER_MODELS))
def test_summarize_matches_repro(model, block, gauss):
    kw = dict(enabled=True, block_ffn=block, block_attn=min(block, 16))
    inv = PAPER_MODELS[model]
    want = jcomp.summarize([jcomp.LayerCost(*c) for c in inv], JComp(**kw),
                           batch=4, gauss=gauss)
    got = tcomp.summarize([tcomp.LayerCost(*c) for c in inv], TComp(**kw),
                          batch=4, gauss=gauss)
    assert got == want


@pytest.mark.parametrize("n_in,n_out,k", [(256, 128, 16), (1440, 160, 16),
                                           (100, 30, 8), (2048, 5632, 128)])
def test_accounting_helpers_match_repro(n_in, n_out, k):
    for gauss in (True, False):
        assert (tcc.bc_flops(3, n_in, n_out, k, gauss)
                == jcc.bc_flops(3, n_in, n_out, k, gauss))
    assert tcc.dense_flops(3, n_in, n_out) == jcc.dense_flops(3, n_in, n_out)
    assert (tcc.dense_param_bytes(n_in, n_out)
            == jcc.dense_param_bytes(n_in, n_out))
    for spectral in (False, True):
        assert (tcc.bc_param_bytes(n_in, n_out, k, spectral=spectral)
                == jcc.bc_param_bytes(n_in, n_out, k, spectral=spectral))


# ---------------------------------------------------------------------------
# theory
# ---------------------------------------------------------------------------
def _theory_arrays():
    rng = np.random.RandomState(0)
    circ = np.asarray(jcc.materialize_dense(
        jcc.init_block_circulant(jax.random.PRNGKey(0), 32, 32, 32), 32, 32))
    block = np.asarray(jcc.materialize_dense(
        jcc.init_block_circulant(jax.random.PRNGKey(1), 32, 16, 8), 16, 32))
    broken = block.copy()
    broken[0, 0] += 1.0
    return {"circulant": circ, "block_circulant": block, "broken": broken,
            "dense": rng.randn(32, 32), "rect": rng.randn(24, 16)}


@pytest.mark.parametrize("name", ["circulant", "block_circulant", "broken",
                                  "dense", "rect"])
def test_theory_certificates_match_repro(name):
    W = _theory_arrays()[name]
    for k in (4, 8, 16, 32):
        assert (ttheory.is_block_circulant(W, k)
                == jtheory.is_block_circulant(W, k))
    if W.shape[0] == W.shape[1]:
        np.testing.assert_array_equal(ttheory.displacement(W),
                                      jtheory.displacement(W))
        assert (ttheory.displacement_rank(W)
                == jtheory.displacement_rank(W))
    np.testing.assert_array_equal(ttheory.cyclic_shift(7),
                                  jtheory.cyclic_shift(7))


def test_theory_certificates_hold():
    arrs = _theory_arrays()
    assert ttheory.displacement_rank(arrs["circulant"]) <= 2
    assert ttheory.displacement_rank(arrs["dense"]) > 16
    assert ttheory.is_block_circulant(arrs["block_circulant"], 8)
    assert not ttheory.is_block_circulant(arrs["broken"], 8)


def test_training_preserves_structure():
    """A gradient step on the generators (through the port's backward)
    keeps the learnt W block-circulant."""
    gen = torch.Generator().manual_seed(0)
    w = tcc.init_block_circulant(32, 16, 8, generator=gen,
                                 device="cpu").requires_grad_(True)
    x = torch.randn((4, 32), generator=gen)
    tcc.bc_matmul_fft(x, w, 16).pow(2).sum().backward()
    with torch.no_grad():
        W2 = tcc.materialize_dense(w - 0.05 * w.grad, 16, 32).numpy()
    assert ttheory.is_block_circulant(W2, 8)


DEMO = dict(n_in=8, width=128, k=8, steps=200)
DEMO_SEEDS = range(8)


def _target(X):
    return np.sin(X.sum(axis=-1))


@pytest.fixture
def one_thread():
    """Small products: one torch thread is faster than a pool contended
    by the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_universal_approximation_demo(one_thread):
    """The drop ``repro``'s tests/test_theory.py asks for (final error
    under a quarter of the initial one, and under 0.05), at its settings.
    The draws differ from ``jax.random``, and the absolute bound depends
    on them: ``repro`` itself meets it at 2 of the seeds 0-7 (0.043 at
    seed 0, its test's).  So over those seeds every port run must show the
    4x drop, and the port must meet the 0.05 bound at as many seeds as
    ``repro`` does."""
    want = [jtheory.universal_approx_demo(_target, seed=s, **DEMO)
            for s in DEMO_SEEDS]
    got = [ttheory.universal_approx_demo(
        _target, generator=torch.Generator().manual_seed(s), seed=s, **DEMO)
        for s in DEMO_SEEDS]
    assert all(final < 0.25 * init for init, final in got), got
    hits = lambda runs: sum(final < 0.05 for _, final in runs)  # noqa: E731
    assert hits(got) >= hits(want) >= 1, (got, want)
