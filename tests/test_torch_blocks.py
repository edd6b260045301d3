"""Block sizes the card's kernels used to refuse, against ``repro`` on the
CPU: k = 4, 5 and 12 (below 8, odd, not a multiple of 8) and k = 256.

* ``bc_matmul_spectral`` and ``bc_matmul_fft`` (values, and the gradients
  of both inputs against ``jax.vjp``), within 1e-5 of the output's scale
  (float32 sums in another order);
* a 2-layer tinyllama (smoke widths; d_model 512 at k = 256, so a block
  spans two heads) with every projection at block size k: greedy tokens
  through both batch ``Engine``s equal, and the training loss within 1e-5
  and every gradient within 1e-4 of its scale against ``jax.grad`` of
  ``repro``'s loss.  At k <= 8 ``repro``'s auto path materializes the
  blocks (``direct``); ``path="spectral"`` (its override, which the card's
  ``block_sizes`` phase takes) runs them through the spectral planes and
  the FFT backward, the kernels' path;
* the CONV layer at k = 4 forward and backward;
* the kernels' arithmetic at these k, replayed in plain PyTorch (no card
  here): ``bc_fused``'s DFT panel padded to the tensor-core tile of 8 and
  its transpose give the length-k rfft and irfft (odd k: no Nyquist
  bin), ``bc_grad_w``'s packed spectra, per-slot contraction and
  weighted iDFT give ``bc_grad_w_plain``, and ``bc_fused``'s plan covers
  every output tile and every row's DFT exactly once.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_smoke_config as jget  # noqa: E402
from repro.core import circulant as jcc  # noqa: E402
from repro.core import conv as jconv  # noqa: E402
from repro.models.registry import build_model  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.configs.registry import get_smoke_config as tget  # noqa: E402
from repro_torch.core import circulant as tcc  # noqa: E402
from repro_torch.core import conv as tconv  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.kernels import bc_fused as bcf  # noqa: E402
from repro_torch.kernels import bc_grad_w as bgw  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402

ARCH = "tinyllama-1.1b"
BLOCKS = (4, 5, 12, 256)
# the model tests' (block size, compression.path)
MODEL_CASES = [(4, "auto"), (4, "spectral"), (5, "spectral"), (12, "auto"),
               (256, "auto")]
MODEL_IDS = [f"k{k}-{path}" for k, path in MODEL_CASES]
TOL = 1e-5


def _close(got, want, tol=TOL, what=""):
    want = np.asarray(want, dtype=np.float32)
    err = float(np.abs(np.asarray(got, dtype=np.float32) - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), (what, err)


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _dims(k):
    """(n_in, n_out) of a projection at block size k: neither a multiple of
    k below 256 (padded blocks), two and three blocks at k = 256."""
    return (512, 700) if k == 256 else (30, 22)


# ---------------------------------------------------------------------------
# the spectral and FFT products
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", BLOCKS)
def test_spectral_and_fft_products_match_repro(k):
    n_in, n_out = _dims(k)
    p, q = tcc.num_blocks(n_out, k), tcc.num_blocks(n_in, k)
    w, x = 0.1 * _x((p, q, k), 1), _x((3, 5, n_in), 2)
    ct = _x((3, 5, n_out), 3)
    jcache = jcc.spectral_cache(jnp.asarray(w))
    tcache = tcc.spectral_cache(torch.from_numpy(w))
    want = jcc.bc_matmul_spectral(jnp.asarray(x), jcache, k, n_out)
    got = tcc.bc_matmul_spectral(torch.from_numpy(x), tcache, k, n_out)
    _close(got.numpy(), want, what="spectral")
    y, vjp = jax.vjp(lambda a, b: jcc.bc_matmul_fft(a, b, n_out),
                     jnp.asarray(x), jnp.asarray(w))
    gx_want, gw_want = vjp(jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    yt = tcc.bc_matmul_fft(xt, wt, n_out)
    (yt * torch.from_numpy(ct)).sum().backward()
    _close(yt.detach().numpy(), y, what="fft")
    _close(xt.grad.numpy(), gx_want, what="dx")
    _close(wt.grad.numpy(), gw_want, what="dw")


# ---------------------------------------------------------------------------
# a 2-layer model at block size k
# ---------------------------------------------------------------------------
def _cfgs(k, path):
    out = []
    for get in (jget, tget):
        cfg = get(ARCH).replace(dtype="float32", num_layers=2)
        if k == 256:
            cfg = cfg.replace(d_model=512, d_ff=1024, attention=dataclasses
                              .replace(cfg.attention, head_dim=128))
        out.append(cfg.replace(compression=dataclasses.replace(
            cfg.compression, block_ffn=k, block_attn=k, path=path)))
    return out


@functools.lru_cache(maxsize=None)
def _setup(k, path):
    """Both configs, ``repro``'s tree drawn N(0, 0.1^2) with numpy (shapes
    from ``jax.eval_shape``) and the port's copy of it."""
    cfg, tcfg = _cfgs(k, path)
    shapes = jax.eval_shape(lambda: build_model(cfg).init(
        jax.random.PRNGKey(0)))
    rng = np.random.RandomState(k)
    tree = jax.tree.map(lambda s: (0.1 * rng.randn(*s.shape)).astype(
        np.float32), shapes)
    return cfg, tcfg, tree


def _toks(results):
    return [r["tokens"] for r in results]


@pytest.mark.parametrize("k,path", MODEL_CASES, ids=MODEL_IDS)
def test_greedy_tokens_match_repro(k, path):
    cfg, tcfg, tree = _setup(k, path)
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, 500, size=n).astype(np.int32)
               for n in (9, 6)]
    reqs = lambda mod: [mod.Request(prompt=p, max_new_tokens=6, id=i)  # noqa: E731
                        for i, p in enumerate(prompts)]
    want = jeng.Engine(cfg, jax.tree.map(jnp.asarray, tree), max_seq=32,
                       bucket_prompts=False).generate(reqs(jeng))
    model = from_jax_params(tree, tcfg, device="cpu")
    got = teng.Engine(tcfg, model, device="cpu", max_seq=32,
                      bucket_prompts=False).generate(reqs(teng))
    assert _toks(got) == _toks(want)


@functools.lru_cache(maxsize=None)
def _repro_grads():
    """``repro``'s loss and gradients at every case, one compiled
    program."""
    cases = {c: (*_setup(*c), SyntheticLM(_setup(*c)[1], batch=2, seq=12,
                                          seed=3)(0)) for c in MODEL_CASES}
    fns = [jax.value_and_grad(jts.make_loss_fn(c[0]), has_aux=True)
           for c in cases.values()]
    args = [(jax.tree.map(jnp.asarray, tree),
             {n: jnp.asarray(v.numpy()) for n, v in batch.items()})
            for _, _, tree, batch in cases.values()]
    outs = jax.jit(lambda *a: [f(*x) for f, x in zip(fns, a)]).lower(
        *args).compile(compiler_options={
            "xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True})(*args)
    return {k: (loss, grads) for k, ((loss, _), grads) in zip(cases, outs)}


@pytest.mark.parametrize("k,path", MODEL_CASES, ids=MODEL_IDS)
def test_loss_and_grads_match_jax_grad(k, path):
    _, tcfg, tree = _setup(k, path)
    jloss, jgrads = _repro_grads()[(k, path)]
    batch = SyntheticLM(tcfg, batch=2, seq=12, seed=3)(0)
    state = ts.init_state(tcfg, adamw.AdamWConfig(),
                          model=from_jax_params(tree, tcfg, device="cpu"))
    loss, _, grads = ts.make_train_step(tcfg, adamw.AdamWConfig()).grads(
        state, batch)
    _close(loss, jloss, what="loss")
    want = {n: p.detach().numpy() for n, p in from_jax_params(
        jax.tree.map(np.array, jgrads), tcfg,
        device="cpu").named_parameters()}
    names = {id(p): n for n, p in state["model"].named_parameters()}
    got = {names[id(t)]: g.numpy()
           for leaf, gs in zip(ts.param_leaves(state["model"], tcfg), grads)
           for t, g in zip(leaf.tensors, gs)}
    assert set(got) == set(want)
    for name in want:
        _close(got[name], want[name], 1e-4, name)


# ---------------------------------------------------------------------------
# the CONV layer at k = 4
# ---------------------------------------------------------------------------
def test_conv_k4_matches_jax_grad():
    """``cifar_wrn``'s 3x3 SAME layer form at block 4 (r^2 C = 72 = 18
    blocks, P = 12 = 3 blocks): forward and both gradients."""
    r, C, P, k = 3, 8, 12, 4
    wj = np.asarray(jconv.init_conv_circulant(jax.random.PRNGKey(3), r, C,
                                              P, k))
    x, ct = _x((2, 6, 6, C), 4), _x((2, 6, 6, P), 5)

    def loss(xx, ww):
        return jnp.sum(jconv.conv2d_block_circulant(xx, ww, r, P, 1,
                                                    "SAME") * ct)
    gx_want, gw_want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x),
                                                      jnp.asarray(wj))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(wj.copy()).requires_grad_(True)
    y = tconv.conv2d_block_circulant(xt, wt, r, P, 1, "SAME")
    _close(y.detach().numpy(), jconv.conv2d_block_circulant(
        jnp.asarray(x), jnp.asarray(wj), r, P, 1, "SAME"))
    (y * torch.from_numpy(ct)).sum().backward()
    _close(xt.grad.numpy(), gx_want)
    _close(wt.grad.numpy(), gw_want)


# ---------------------------------------------------------------------------
# the kernels' arithmetic, replayed on the CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", BLOCKS + (1, 2, 7))
def test_bc_fused_padded_panel_is_the_length_k_dft(k):
    """xb's rows padded with zero columns to kpad(k), times the panel
    (zero rows past k), are rfft(x) (Cr, Ci interleaved); the MAC's bin
    weights times the transposed panel, cut to k columns, invert it."""
    x = torch.from_numpy(_x((6, k), 8)).double()
    panel = bcf.dft_panel(k, "cpu").double()
    kp, kf = bcf.kpad(k), k // 2 + 1
    assert panel.shape == (kp, bcf.ncols(k)) and kp % 8 == 0
    assert not panel[k:].any() and not panel[:, 2 * kf:].any()
    X = torch.nn.functional.pad(x, (0, kp - k)) @ panel
    want = torch.fft.rfft(x, dim=-1)
    torch.testing.assert_close(X[:, 0:2 * kf:2], want.real, rtol=0,
                               atol=1e-5)
    torch.testing.assert_close(X[:, 1:2 * kf:2], want.imag, rtol=0,
                               atol=1e-5)
    w = torch.full((kf,), 2.0 / k, dtype=torch.float64)
    w[0] = 1.0 / k
    if k % 2 == 0:
        w[-1] = 1.0 / k                    # the Nyquist bin: even k only
    wcol = torch.zeros(panel.shape[1], dtype=torch.float64)
    wcol[0:2 * kf:2], wcol[1:2 * kf:2] = w, w
    back = (X * wcol) @ bcf.dft_panel_t(k, "cpu").double()
    assert back.shape == (6, kp)
    torch.testing.assert_close(back[:, :k], x, rtol=0, atol=1e-5)


@pytest.mark.parametrize("k", (4, 5, 12, 1, 3))
def test_bc_grad_w_unfolded_decomposition_matches_plain(k):
    """The kernel's path for a k that does not fold: packed spectra x @ P^T
    (2 S columns, S = (k + 1) // 2 slots; an odd k's column 1 is zeros),
    slot 0's two real products and each other slot's complex correlation
    summed over the rows, then (u * w) @ P with w = 1/k on columns 0, 1."""
    N, p, q = 40, 3, 2
    gy = torch.from_numpy(_x((N, p, k), 10)).double()
    xb = torch.from_numpy(_x((N, q, k), 11)).double()
    assert not bgw.folded(k)
    P = bgw.packed_panel_t(k, "cpu").double()
    S = bgw.slots(k)
    assert P.shape == (2 * S, k)
    G, X = gy @ P.T, xb @ P.T                       # (N, ., 2 S)
    u = torch.zeros((p, q, 2 * S), dtype=torch.float64)
    prod = lambda a, b: torch.einsum("np,nq->pq", a, b)  # noqa: E731
    u[..., 0] = prod(G[..., 0], X[..., 0])
    u[..., 1] = prod(G[..., 1], X[..., 1])
    for s in range(1, S):
        gr, gi, xr, xi = G[..., 2 * s], G[..., 2 * s + 1], X[..., 2 * s], \
            X[..., 2 * s + 1]
        u[..., 2 * s] = prod(gr, xr) + prod(gi, xi)
        u[..., 2 * s + 1] = prod(gi, xr) - prod(gr, xi)
    w = torch.full((2 * S,), 2.0 / k, dtype=torch.float64)
    w[:2] = 1.0 / k
    got = (u * w) @ P
    want = bgw.bc_grad_w_plain(gy.float(), xb.float(), k).double()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def _coverage(pl, B, p, q, k):
    """The kernel's indexing with plan ``pl``, replayed on the host:
    writes of each (row, output block, 8-column tile of kpad(k)) and DFTs
    of each (row, input block)."""
    nt = bcf.kpad(k) // 8
    out = torch.zeros((B, p, nt), dtype=torch.int64)
    dft = torch.zeros((B, q), dtype=torch.int64)
    R, cs = pl.rows, pl.cluster
    for row0 in range(0, B, R):
        nrow = min(R, B - row0)
        for rank in range(cs):
            if pl.mode == bcf.P_SPLIT:
                i0 = rank * pl.share
                out[row0:row0 + nrow, i0:i0 + max(0, min(pl.share,
                                                         p - i0))] += 1
                for c0 in range(0, q, pl.qchunk):
                    qcur = min(pl.qchunk, q - c0)
                    per = -(-R * qcur // cs)
                    for m in range(rank * per, min((rank + 1) * per,
                                                   R * qcur)):
                        if m % R < nrow:
                            dft[row0 + m % R, c0 + m // R] += 1
            else:
                j0 = rank * pl.share
                dft[row0:row0 + nrow, j0:j0 + max(0, min(pl.share,
                                                         q - j0))] += 1
                per = -(-nt // cs)
                t0 = min(nt, rank * per)
                out[row0:row0 + nrow, :, t0:min(nt, t0 + per)] += 1
    return out, dft


# tinyllama's projections at each k: (p, q) of q/o, k/v, up/gate, down
def _tiny_shapes(k):
    nb = lambda n: -(-n // k)  # noqa: E731
    return [(nb(2048), nb(2048)), (nb(256), nb(2048)), (nb(5632), nb(2048)),
            (nb(2048), nb(5632))]


@pytest.mark.parametrize("B", (1, 8, 64, 300))
@pytest.mark.parametrize("k", BLOCKS)
def test_bc_fused_plan_at_block_size(k, B):
    """Every lane plans tinyllama's four projections at k: one plan for
    the three lanes, within the shared memory it states, each output tile
    written and each row's DFT computed exactly once.  The panel is staged
    in shared memory up to k = 176 and read from memory above."""
    assert bcf.panel_staged(k) == (k <= 176)
    for p, q in _tiny_shapes(k):
        lanes = {bcf.plan(B, p, q, k, lane) for lane in bcf.LANES.values()}
        assert len(lanes) == 1
        pl = lanes.pop()
        assert pl.smem_bytes == bcf.smem_bytes(p, q, k, pl.rows, pl.cluster,
                                               pl.mode, pl.share, pl.qchunk)
        assert pl.smem_bytes <= bcf.MAX_SMEM
        if p * q * B > 200000:              # the replay's cost, not a limit
            continue
        out, dft = _coverage(pl, B, p, q, k)
        assert bool((out == 1).all()) and bool((dft == 1).all())


# tinyllama-1.1b's full-width plane shapes (p, q, kf) at block sizes 4,
# 16 and 256: spectral_matmul's block stages a bin chunk's three (q, p)
# planes whole, so it takes none at 4, only k/v at 16, all at 256
LANE_CASES = [(4, (512, 512, 3), "bc_fused"), (4, (1408, 512, 3), "bc_fused"),
              (16, (16, 128, 9), "spectral_matmul"),
              (16, (352, 128, 9), "bc_fused"),
              (256, (22, 8, 129), "spectral_matmul"),
              (256, (8, 22, 129), "spectral_matmul")]


@pytest.mark.parametrize("k,shape,lane", LANE_CASES,
                         ids=[f"k{k}-{'x'.join(map(str, s))}"
                              for k, s, _ in LANE_CASES])
def test_prefill_contract_lane_by_shape(k, shape, lane):
    contract = teng.PrefillContract()
    cache = {n: torch.empty(shape, device="meta")     # the Gauss planes
             for n in ("wr", "ws1", "ws2")}
    assert contract.takes(cache) == (lane == "spectral_matmul")
    assert contract.report()[lane] == ["x".join(map(str, shape))]
    assert (shape in contract.reasons) == (lane == "bc_fused")


@pytest.mark.parametrize("lane", ["spectral_matmul", "bc_fused"])
def test_spectral_linear_takes_the_hook_only_where_it_plans(lane):
    """A projection the contract does not take goes through the fused
    kernel's path; one it takes through the hook; both give the plain
    spectral product (within 1e-5 of scale)."""
    calls = []

    class Counting(teng.PrefillContract):
        def __call__(self, xr, xi, cache):
            calls.append(cache["wr"].shape)
            return super().__call__(xr, xi, cache)

    k, n_in, n_out = 12, 60, 36
    w = tcc.init_block_circulant(n_in, n_out, k, generator=torch.Generator()
                                 .manual_seed(0), device="cpu")
    cache = tcc.spectral_cache(w)
    hook = Counting()
    hook.lanes[tuple(cache["wr"].shape)] = lane
    x = torch.as_tensor(_x((3, 5, n_in)))
    got = tcc._spectral_linear(x, cache, k, True, n_out, hook)
    _close(got, tcc.bc_matmul_spectral(x, cache, k, n_out))
    assert len(calls) == (lane == "spectral_matmul")
