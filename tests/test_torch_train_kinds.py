"""Training the MoE and windowed-attention archs in the port against
``repro`` on the CPU (smoke configs, float32, the same weights and the same
numpy batch, S = 24 past the smoke window of 16):

* mixtral-8x7b (``moe_swa``: every layer windowed, 4 experts top-2),
  llama4-maverick-400b-a17b (``attn`` / ``moe``, a shared expert, top-1)
  and gemma2-9b (``attn_local`` / ``attn``, softcaps, sandwich norms): the
  loss, ``nll``, ``moe_aux`` and every parameter's gradient against
  ``jax.grad`` of ``repro``'s loss (loss within 1e-5 of its scale, each
  gradient within 1e-4 of its own), carried across by ``from_jax_params``;
  both MoE archs again at ``capacity_factor`` 1.0, where choices drop;
* the MoE layer with drops, alone: output, aux and the gradients of the
  input and the router against ``jax.vjp`` of ``repro``'s ``moe`` (a
  choice dropped otherwise would move the output by its whole term);
* the expert stack's autograd function (``core/circulant.py:
  BCMatmulFFT`` with a leading expert axis) and the stack lanes of
  ``bc_grad_w`` / ``bc_fused`` (plain versions here) against ``jax.vjp``
  of ``jax.vmap(bc_matmul_fft)``;
* one AdamW step of a MoE tree (float32 and int8 moments) against
  ``repro``'s; remat against none, bit for bit; the launcher; a checkpoint
  resume, bit-equal; the expert stacks re-baked after a step; the router
  logit gap left alone in train mode.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import CompressionConfig, MoEConfig  # noqa: E402
from repro.configs.registry import get_smoke_config as jget  # noqa: E402
from repro.core import circulant as jcc  # noqa: E402
from repro.layers import ffn as jffn  # noqa: E402
from repro.models.registry import build_model  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.configs.base import CompressionConfig as TComp  # noqa: E402
from repro_torch.configs.base import MoEConfig as TMoE  # noqa: E402
from repro_torch.configs.registry import get_smoke_config as tget  # noqa: E402
from repro_torch.core import circulant as tcc  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.kernels import bc_grad_w as tgw  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.layers import ffn as tffn  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve.params import precompute_serving_params  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402

MIXTRAL, LLAMA4, GEMMA2 = ("mixtral-8x7b", "llama4-maverick-400b-a17b",
                           "gemma2-9b")
B, S = 2, 24
# (case, arch, capacity_factor or None: the smoke config's 8.0, no drops)
CASES = {MIXTRAL: (MIXTRAL, None), LLAMA4: (LLAMA4, None),
         GEMMA2: (GEMMA2, None), f"{MIXTRAL}_drops": (MIXTRAL, 1.0),
         f"{LLAMA4}_drops": (LLAMA4, 1.0)}


def _with_capacity(cfg, capacity):
    if capacity is None:
        return cfg
    return cfg.replace(moe=dataclasses.replace(cfg.moe,
                                               capacity_factor=capacity))


@functools.lru_cache(maxsize=None)
def _setups():
    """Per case: ``repro``'s config, the port's, ``repro``'s parameter
    tree with numpy draws N(0, 0.1^2) on every leaf (shapes from
    ``jax.eval_shape``), a batch, and ``repro``'s loss, metrics and
    gradients, all five compiled as one XLA program at its lowest backend
    optimization level."""
    cases = {}
    for name, (arch, capacity) in CASES.items():
        cfg = _with_capacity(jget(arch).replace(dtype="float32"), capacity)
        tcfg = _with_capacity(tget(arch).replace(dtype="float32"), capacity)
        shapes = jax.eval_shape(lambda c=cfg: build_model(c).init(
            jax.random.PRNGKey(0)))
        rng = np.random.RandomState(1)
        tree = jax.tree.map(lambda s: (0.1 * rng.randn(*s.shape)).astype(
            np.float32), shapes)
        batch = SyntheticLM(tcfg, batch=B, seq=S, seed=3)(0)
        cases[name] = (cfg, tcfg, tree, batch)
    fns = [jax.value_and_grad(jts.make_loss_fn(c[0]), has_aux=True)
           for c in cases.values()]
    args = [(jax.tree.map(jnp.asarray, tree), _jbatch(batch))
            for _, _, tree, batch in cases.values()]
    outs = _compile(lambda *a: [f(*x) for f, x in zip(fns, a)], *args)(
        *args)
    return {name: (*cases[name], metrics, grads)
            for name, ((_, metrics), grads) in zip(cases, outs)}


def _compile(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})


def _jbatch(batch):
    return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


def _close(got, ref, rel, what=""):
    ref = np.asarray(ref, dtype=np.float32)
    err = float(np.abs(np.asarray(got, dtype=np.float32) - ref).max())
    assert err <= rel * max(1.0, float(np.abs(ref).max())), (what, err)


def _params(model):
    return {n: p.detach().numpy() for n, p in model.named_parameters()}


def _grads_by_name(state, cfg, grads):
    leaves = ts.param_leaves(state["model"], cfg)
    names = {id(p): n for n, p in state["model"].named_parameters()}
    return {names[id(t)]: g.numpy() for leaf, gs in zip(leaves, grads)
            for t, g in zip(leaf.tensors, gs)}


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grads_match_jax_grad(case):
    _, tcfg, tree, batch, jm, jgrads = _setups()[case]
    state = ts.init_state(tcfg, adamw.AdamWConfig(),
                          model=from_jax_params(tree, tcfg, device="cpu"))
    loss, m, grads = ts.make_train_step(tcfg, adamw.AdamWConfig()).grads(
        state, batch)
    for key in ("loss", "nll", "moe_aux"):
        _close(m[key], jm[key], 1e-5, key)
    if tcfg.moe.num_experts:
        assert float(m["moe_aux"]) > 0
    want = _params(from_jax_params(jax.tree.map(np.array, jgrads), tcfg,
                                   device="cpu"))
    got = _grads_by_name(state, tcfg, grads)
    assert set(got) == set(want)
    for name in want:
        _close(got[name], want[name], 1e-4, name)


# ---------------------------------------------------------------------------
# the MoE layer with drops
# ---------------------------------------------------------------------------
D_MODEL, D_FF, E = 64, 128, 4


def _moe_layer(topk, block):
    kw = dict(num_experts=E, top_k=topk, capacity_factor=1.0,
              shared_expert=True, router_group_size=8)
    ckw = dict(enabled=bool(block), block_ffn=block, block_expert=block)
    jm, jc, tm, tc = MoEConfig(**kw), CompressionConfig(**ckw), \
        TMoE(**kw), TComp(**ckw)
    shapes = jax.eval_shape(lambda: jffn.init_moe(
        jax.random.PRNGKey(0), D_MODEL, D_FF, jm, jc))
    rng = np.random.RandomState(2)
    tree = jax.tree.map(lambda s: (0.3 * rng.randn(*s.shape)).astype(
        np.float32), shapes)
    m = tffn.MoE(D_MODEL, D_FF, tm, tc, device=torch.device("cpu"))
    with torch.no_grad():
        m.router.copy_(torch.from_numpy(tree["router"]))
        for name in tffn.EXPERT_PROJECTIONS:
            getattr(m.experts, name).copy_(torch.from_numpy(
                tree["experts"][name]))
            leaf = tree["shared"][name]
            key = "wc" if "wc" in leaf else "w"
            getattr(getattr(m.shared, name), key).copy_(
                torch.from_numpy(leaf[key]))
    return jm, jc, tm, tc, tree, m


@pytest.mark.parametrize("topk,block", [(1, 16), (2, 16), (2, 0)])
def test_moe_with_drops_matches_repro(topk, block):
    """At capacity factor 1.0 some choices drop (the kept count says so);
    the train-mode output, the aux loss and the gradients of the input
    and the router match ``jax.vjp`` of ``repro``'s ``moe`` (1e-5 of the
    output's scale, 1e-4 of each gradient's), so the same choices dropped.
    Circulant experts (block 16, through the expert stack's autograd
    function) and dense ones."""
    jm, jc, tm, tc, tree, m = _moe_layer(topk, block)
    x = np.random.RandomState(5).randn(2, 16, D_MODEL).astype(np.float32)
    gout = np.random.RandomState(6).randn(2, 16, D_MODEL).astype(np.float32)
    params = jax.tree.map(jnp.asarray, tree)

    def ref(xx, router, gg):
        out, vjp = jax.vjp(lambda a, r: jffn.moe(
            {**params, "router": r}, a, d_ff=D_FF, moe_cfg=jm, comp=jc,
            mode="train"), xx, router)
        return out, vjp((gg, jnp.ones((), jnp.float32)))
    args = (jnp.asarray(x), params["router"], jnp.asarray(gout))
    (jout, jaux), (jgx, jgr) = _compile(ref, *args)(*args)
    m.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = tffn.moe(m, xt, d_ff=D_FF, moe_cfg=tm, comp=tc, mode="train")
    ((out * torch.from_numpy(gout)).sum() + aux).backward()
    _close(out.detach().numpy(), jout, 1e-5, "out")
    _close(aux.detach().numpy(), jaux, 1e-5, "aux")
    _close(xt.grad.numpy(), jgx, 1e-4, "dx")
    _close(m.router.grad.numpy(), jgr, 1e-4, "drouter")
    g = 8
    cap = max(1, int(np.ceil(g * topk / E * 1.0)))
    disp, _, _, _ = tffn.route(m.router.detach(), xt.detach().reshape(
        -1, g, D_MODEL), E, topk, cap)
    assert int(disp.sum()) < 2 * 16 * topk                  # drops happened


# ---------------------------------------------------------------------------
# the expert stack's autograd function and the stack lanes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("gauss", [True, False])
def test_expert_stack_function_matches_vjp_of_vmap(gauss):
    """``bc_matmul_fft`` on an expert stack (E = 3 experts of C = 37 rows,
    n_in = 40 -> n_out = 56 at k = 8: padded blocks both ways): output and
    both gradients against ``jax.vjp`` of ``jax.vmap(bc_matmul_fft)``
    within 1e-5 / 1e-4 of their scale."""
    rng = np.random.RandomState(11)
    Ex, C, n_in, n_out, k = 3, 37, 40, 56, 8
    p, q = tcc.num_blocks(n_out, k), tcc.num_blocks(n_in, k)
    x = rng.randn(Ex, C, n_in).astype(np.float32)
    w = (rng.randn(Ex, p, q, k) / np.sqrt(n_in)).astype(np.float32)
    g = rng.randn(Ex, C, n_out).astype(np.float32)
    fn = jax.vmap(lambda ww, xx: jcc.bc_matmul_fft(xx, ww, n_out, gauss))

    def ref(ww, xx, gg):
        out, vjp = jax.vjp(fn, ww, xx)
        return out, vjp(gg)
    args = tuple(map(jnp.asarray, (w, x, g)))
    want, (jgw, jgx) = _compile(ref, *args)(*args)
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    got = tcc.bc_matmul_fft(xt, wt, n_out, gauss)
    got.backward(torch.from_numpy(g))
    _close(got.detach().numpy(), want, 1e-5, "y")
    _close(xt.grad.numpy(), jgx, 1e-4, "dx")
    _close(wt.grad.numpy(), jgw, 1e-4, "dw")


def test_stack_lanes_are_the_per_expert_calls():
    """On the CPU the stack lanes are their plain versions expert by
    expert: ``bc_grad_w`` over (E, C, ., k) equals ``bc_grad_w_plain`` of
    each expert's rows bit for bit, ``bc_forward`` / ``bc_adjoint`` equal
    the single projection's; the stack's adjoint planes transpose the
    block axes of each expert's planes."""
    rng = np.random.RandomState(12)
    Ex, C, p, q, k = 3, 21, 5, 4, 16
    gy = torch.from_numpy(rng.randn(Ex, C, p, k).astype(np.float32))
    xb = torch.from_numpy(rng.randn(Ex, C, q, k).astype(np.float32))
    w = torch.from_numpy(rng.randn(Ex, p, q, k).astype(np.float32))
    gw = tops.bc_grad_w(gy, xb, k)
    assert gw.shape == (Ex, p, q, k)
    adj = tops.adjoint_planes(tcc.spectral_cache(w))
    for e in range(Ex):
        assert torch.equal(gw[e], tgw.bc_grad_w_plain(gy[e], xb[e], k))
        one = tops.adjoint_planes(tcc.spectral_cache(w[e]))
        assert all(torch.equal(adj[n][e], one[n]) for n in one)
    fwd, bwd = tops.bc_forward(xb, w), tops.bc_adjoint(gy, w)
    for e in range(Ex):
        assert torch.equal(fwd[e], tops.bc_forward(xb[e], w[e]))
        assert torch.equal(bwd[e], tops.bc_adjoint(gy[e], w[e]))


@pytest.mark.parametrize("C,p,q,E,want", [
    (80, 64, 40, 128, (128, 1, 32)),        # llama4's up/gate at train_llama4
    (80, 40, 64, 128, (128, 1, 32)),        # its down
    (2880, 112, 32, 8, (2944, 1, 1)),       # mixtral's up/gate at train_mixtral
    (2880, 32, 112, 8, (2944, 1, 1)),       # its down
    (37, 3, 5, 1, (128, 1, 1))])
def test_bc_grad_w_stack_plan(C, p, q, E, want):
    """An expert stack's plan is one expert's (the single call's at N = C),
    in groups whose spectra and partial sums each fit ``CHUNK_BYTES``,
    whose contraction grid's z fits, and which cover the E experts in
    groups of at most one expert's difference."""
    k = 128 if E > 1 else 8
    pl = tgw.plan(C, p, q, k)
    group = tgw.stack_group(E, pl)
    assert (pl.chunk, pl.chunks, group) == want
    assert 4 * group * max(pl.spec_floats, pl.part_floats) <= \
        tgw.CHUNK_BYTES or group == 1
    assert group * pl.splits <= tgw.MAX_GRID_Z
    groups = tgw.cdiv(E, group)
    assert (groups - 1) * group < E <= groups * group
    assert tgw.shape_key(C, p, q, k, E) == (
        f"bc_grad_w/{E}x{C}x{p}x{q}x{k}" if E > 1
        else f"bc_grad_w/{C}x{p}x{q}x{k}")


# ---------------------------------------------------------------------------
# the step, remat, the launcher, checkpoints, re-baking
# ---------------------------------------------------------------------------
def _jstate_leaf(tree, name):
    node = tree
    for part in name.split("/"):
        node = node[int(part)] if isinstance(node, (list, tuple)) else \
            node[part]
    return node


@pytest.mark.parametrize("quantize", [False, True])
def test_adamw_step_of_a_moe_tree_matches_repro(quantize):
    """One step of llama4's tree (expert stacks, router, shared expert,
    dense and MoE segments) from ``repro``'s gradients: parameters within
    1e-5; moments within 1e-4 of their scale, or int8 / uint8 codes at
    most one step apart with scales within 1e-5.  Leaf names are
    ``repro``'s tree paths (the moments are looked up by them) and decay
    follows their stacked rank."""
    _, tcfg, tree, batch, _, jgrads = _setups()[LLAMA4]
    opt = jadamw.AdamWConfig(lr=1e-3, quantize_moments=quantize)

    def step(params, grads):
        st = jadamw.init(params, opt)
        return jadamw.update(grads, st, params, opt, opt.lr)
    args = (jax.tree.map(jnp.asarray, tree), jgrads)
    jparams, jopt = _compile(step, *args)(*args)
    topt = adamw.AdamWConfig(lr=1e-3, quantize_moments=quantize)
    state = ts.init_state(tcfg, topt,
                          model=from_jax_params(tree, tcfg, device="cpu"))
    leaves = ts.param_leaves(state["model"], tcfg)
    assert any("/moe/experts/up" in leaf.name for leaf in leaves)
    grads = []
    for leaf in leaves:                       # a stacked leaf, layer by layer
        g = np.array(_jstate_leaf(jgrads, leaf.name))
        grads.append([torch.from_numpy(a) for a in (
            g if leaf.rank > leaf.tensors[0].dim() else [g])])
    new, mv = adamw.update(grads, state["opt"], leaves, topt, 1e-3)
    for leaf, ps in zip(leaves, new):
        ref = np.asarray(_jstate_leaf(jparams, leaf.name))
        got = np.stack([p.numpy() for p in ps]).reshape(ref.shape)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5,
                                   err_msg=leaf.name)
    for leaf, m in zip(leaves, mv["mv"]):
        jmv = _jstate_leaf(jopt["mv"], leaf.name)
        for key in ("m", "v"):
            got = np.stack([t.numpy() for t in m[key]]).reshape(
                np.shape(jmv[key]))
            ref = np.asarray(jmv[key])
            if quantize:
                assert got.dtype == ref.dtype
                assert np.abs(got.astype(np.int32)
                              - ref.astype(np.int32)).max() <= 1, leaf.name
                _close(m[key + "_s"], jmv[key + "_s"], 1e-5, leaf.name)
            else:
                _close(got, ref, 1e-4, leaf.name)


def test_remat_equals_no_remat():
    """mixtral with every layer under ``checkpoint`` (the MoE's routing,
    the expert stacks and the aux loss recomputed in the backward) gives
    the same loss, aux and gradients, bit for bit, as without."""
    _, tcfg, tree, batch, _, _ = _setups()[f"{MIXTRAL}_drops"]
    out = []
    for remat in ("none", "full"):
        cfg = tcfg.replace(remat=remat)
        state = ts.init_state(cfg, adamw.AdamWConfig(),
                              model=from_jax_params(tree, cfg, device="cpu"))
        out.append(ts.make_train_step(cfg, adamw.AdamWConfig()).grads(
            state, batch))
    assert torch.equal(out[0][1]["moe_aux"], out[1][1]["moe_aux"])
    for a, b in zip([out[0][0]] + [g for gs in out[0][2] for g in gs],
                    [out[1][0]] + [g for gs in out[1][2] for g in gs]):
        assert torch.equal(a, b)


def test_launch_train_mixtral_on_cpu(tmp_path):
    from repro_torch.launch import train
    out = train.main(["--arch", MIXTRAL, "--device", "cpu", "--steps", "2",
                      "--batch", "2", "--seq", "24", "--workdir",
                      str(tmp_path)])
    assert int(out["state"]["step"]) == 2
    assert int(out["state"]["skipped"]) == 0
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert out["registry"].value("train.tokens") == 2 * 2 * 24


def test_moe_checkpoint_resume_is_bit_equal(tmp_path):
    """llama4 (int8 moments): 2 steps, a checkpoint, a new trainer that
    restores it and takes steps 3 and 4, against 4 uninterrupted steps:
    every tensor of the two states equal."""
    tcfg = tget(LLAMA4).replace(dtype="float32")
    data = SyntheticLM(tcfg, batch=B, seq=16, seed=0)
    opt = adamw.AdamWConfig(lr=1e-3, quantize_moments=True)

    def trainer(workdir, steps):
        return Trainer(tcfg, opt, workdir=str(workdir), data_fn=data,
                       total_steps=steps, ckpt_every=2, device="cpu")
    whole = trainer(tmp_path / "a", 4).run()
    trainer(tmp_path / "b", 2).run()
    resumed = trainer(tmp_path / "b", 4)
    assert int(resumed.init_or_restore()["step"]) == 2
    state = resumed.run()
    pairs = list(zip(ckpt.named_tensors(whole), ckpt.named_tensors(state)))
    assert any("experts" in n for (n, _), _ in pairs)
    for (n, x), (_, y) in pairs:
        assert torch.equal(x, y), n


def test_trained_moe_is_rebaked():
    """A step drops the expert stacks' baked ``*_cache`` planes with the
    projections'; baking again gives the planes of the new generators."""
    _, tcfg, tree, batch, _, _ = _setups()[LLAMA4]
    model = precompute_serving_params(from_jax_params(tree, tcfg,
                                                      device="cpu"), tcfg)
    experts = [m for m in model.modules() if isinstance(m, tffn.Experts)]
    assert experts and all(ex.cache("up") is not None for ex in experts)
    old = experts[0].cache("up")["wr"].clone()
    state = ts.init_state(tcfg, adamw.AdamWConfig(lr=1e-2), model=model)
    ts.make_train_step(tcfg, adamw.AdamWConfig(lr=1e-2))(state, batch)
    assert all(ex.cache(n) is None for ex in experts
               for n in tffn.EXPERT_PROJECTIONS)
    precompute_serving_params(model, tcfg)
    for ex in experts:
        for name in tffn.EXPERT_PROJECTIONS:
            want = tcc.spectral_cache(getattr(ex, name).detach())
            for key, t in ex.cache(name).items():
                assert torch.equal(t, want[key])
    assert not torch.equal(experts[0].cache("up")["wr"], old)


def test_train_mode_leaves_the_logit_gap_alone():
    """A MoE's ``logit_gap`` is a serving record: a train step (whose
    recompute under remat would fold it twice) leaves it as it was."""
    _, tcfg, tree, batch, _, _ = _setups()[MIXTRAL]
    cfg = tcfg.replace(remat="full")
    state = ts.init_state(cfg, adamw.AdamWConfig(),
                          model=from_jax_params(tree, cfg, device="cpu"))
    gaps = [m for m in state["model"].modules() if isinstance(m, tffn.MoE)]
    for m in gaps:
        m.logit_gap = torch.full((), float("inf"))
    ts.make_train_step(cfg, adamw.AdamWConfig())(state, batch)
    assert all(float(m.logit_gap) == float("inf") for m in gaps)


def test_cross_entropy_in_chunks_matches_one_chunk(monkeypatch):
    """The loss taken in chunks of rows under ``checkpoint`` (3 rows of
    logits a chunk here, the last one short) equals the one-chunk loss and
    its gradient within 1e-6 of their scale, with the z-loss on."""
    rng = np.random.RandomState(14)
    logits = torch.from_numpy(rng.randn(2, 7, 11).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, 11, size=(2, 7)))
    out = []
    for floats in (ts.CE_CHUNK_FLOATS, 3 * 11):
        monkeypatch.setattr(ts, "CE_CHUNK_FLOATS", floats)
        x = logits.clone().requires_grad_(True)
        loss = ts.cross_entropy(x, labels, zloss=1e-2)
        loss.backward()
        out.append((loss.detach().numpy(), x.grad.numpy()))
    _close(out[1][0], out[0][0], 1e-6, "loss")
    _close(out[1][1], out[0][1], 1e-6, "grad")
