"""``gauss_trick=False`` (the paper's own 4-product MAC, without the Gauss
trick) in the port against ``repro`` on the smoke tinyllama, float32.

Every projection runs the fused kernel's 4-product lane
(``kernels/bc_fused.py:bc_fused4_matmul``), here its plain version on the
CPU: both engines' greedy tokens equal ``repro``'s, the batch engine's
prefill sends every plane shape to that lane with the planner's reason
(``spectral_matmul`` contracts the Gauss planes only), and the training
loss and every gradient are within 1e-5 of ``jax.grad`` of ``repro``'s
loss (of their scale).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_smoke_config as jget  # noqa: E402
from repro.models.registry import build_model  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.configs.registry import get_smoke_config as tget  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.kernels import bc_fused as tbcf  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402

ARCH = "tinyllama-1.1b"


def _nogauss(cfg):
    return cfg.replace(dtype="float32", compression=dataclasses.replace(
        cfg.compression, gauss_trick=False))


@pytest.fixture(scope="module")
def setup():
    cfg, tcfg = _nogauss(jget(ARCH)), _nogauss(tget(ARCH))
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    return cfg, tcfg, params


def _model(tcfg, params):
    return from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                           device="cpu")


def _reqs(cls, specs, seed=0):
    rng = np.random.RandomState(seed)
    return [cls(prompt=rng.randint(1, 500, size=s).astype(np.int32),
                max_new_tokens=n, id=i) for i, (s, n) in enumerate(specs)]


SPECS = [(20, 8), (12, 5), (9, 6)]


def test_batch_engine_matches_repro(setup):
    cfg, tcfg, params = setup
    kw = dict(max_batch=2, max_seq=64)
    want = jeng.Engine(cfg, params, **kw).generate(_reqs(jeng.Request,
                                                         SPECS))
    eng = teng.Engine(tcfg, _model(tcfg, params), device="cpu", **kw)
    got = eng.generate(_reqs(teng.Request, SPECS))
    assert [g["tokens"] for g in got] == [w["tokens"] for w in want]
    lanes = eng.stats()["prefill_lanes"]
    assert lanes["bc_fused"] and not lanes["spectral_matmul"], lanes
    reasons = eng._contract.reasons
    assert set(reasons) == set(eng._contract.lanes)
    assert all("gauss_trick=False" in r for r in reasons.values())


def test_continuous_engine_matches_repro(setup):
    cfg, tcfg, params = setup
    kw = dict(max_slots=2, max_seq=32, page_size=4, decode_chunk=4)
    want = jeng.ContinuousEngine(cfg, params, **kw).generate(
        _reqs(jeng.Request, SPECS))
    got = teng.ContinuousEngine(tcfg, _model(tcfg, params), device="cpu",
                                **kw).generate(_reqs(teng.Request, SPECS))
    assert [g["tokens"] for g in got] == [w["tokens"] for w in want]


def _close(got, ref, rel, what=""):
    ref = np.asarray(ref, dtype=np.float32)
    err = float(np.abs(np.asarray(got, dtype=np.float32) - ref).max())
    assert err <= rel * max(1.0, float(np.abs(ref).max())), (what, err)


def test_loss_and_grads_match_jax_grad(setup):
    cfg, tcfg, params = setup
    shapes = jax.eval_shape(lambda: params)
    rng = np.random.RandomState(1)
    tree = jax.tree.map(lambda s: (0.1 * rng.randn(*s.shape)).astype(
        np.float32), shapes)
    batch = SyntheticLM(tcfg, batch=2, seq=16, seed=3)(0)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jts.make_loss_fn(cfg), has_aux=True))(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    state = ts.init_state(tcfg, adamw.AdamWConfig(),
                          model=from_jax_params(tree, tcfg, device="cpu"))
    before = tbcf.KERNEL.launches
    loss, _, grads = ts.make_train_step(tcfg, adamw.AdamWConfig()).grads(
        state, batch)
    assert tbcf.KERNEL.launches == before            # CPU: the plain path
    _close(loss, jloss, 1e-5, "loss")
    want = {n: p.detach().numpy() for n, p in from_jax_params(
        jax.tree.map(np.array, jgrads), tcfg,
        device="cpu").named_parameters()}
    leaves = ts.param_leaves(state["model"], tcfg)
    names = {id(p): n for n, p in state["model"].named_parameters()}
    got = {names[id(t)]: g.numpy() for leaf, gs in zip(leaves, grads)
           for t, g in zip(leaf.tensors, gs)}
    assert set(got) == set(want)
    for name in want:
        _close(got[name], want[name], 1e-5, name)
