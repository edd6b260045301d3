"""Training the recurrent and encoder-decoder archs in the port against
``repro`` on the CPU (smoke configs, float32, the same weights and the same
numpy batch, S = 24 past the smoke window of 16):

* recurrentgemma-2b at 5 layers (``rec``, ``rec``, ``attn_local``, then
  the remainder segment ``rec``, ``rec``), xlstm-125m (``mlstm``,
  ``mlstm``, ``slstm``, twice) and whisper-large-v3 (2 + 2 layers over 16
  stub frames): the loss, ``nll``, ``moe_aux`` and every parameter's
  gradient against ``jax.grad`` of ``repro``'s loss, carried across by
  ``from_jax_params`` (loss within 1e-5 of its scale, each gradient within
  1e-4 of its own; xlstm's within 1e-3, ``GRAD_TOL``);
* each cell's train-mode block alone (the RG-LRU, the mLSTM over three
  chunks, the sLSTM) on ``repro``'s init: output and the gradients of the
  input and every cell parameter against ``jax.vjp`` of ``repro``'s block
  (1e-5 / 1e-4 of their scale);
* train-mode attention (``masked_attention`` with a window, causal or
  not, softcap, cross-attention's key count) against ``repro``'s
  ``chunked_attention`` with small query and key chunks;
* remat against none, bit for bit; the launcher on whisper; a checkpoint
  resume of whisper's tree, bit-equal.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import CompressionConfig  # noqa: E402
from repro.configs.registry import get_smoke_config as jget  # noqa: E402
from repro.layers import attention as jattn  # noqa: E402
from repro.layers import recurrent as jrec  # noqa: E402
from repro.models.registry import build_model  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.configs.base import CompressionConfig as TComp  # noqa: E402
from repro_torch.configs.registry import get_smoke_config as tget  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.layers import attention as tattn  # noqa: E402
from repro_torch.layers import recurrent as trec  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402

RGEMMA, XLSTM, WHISPER = "recurrentgemma-2b", "xlstm-125m", "whisper-large-v3"
B, S = 2, 24
# config changes of each case: recurrentgemma at 5 layers (one whole
# pattern of 3 and a remainder segment of 2)
CASES = {RGEMMA: dict(num_layers=5), XLSTM: {}, WHISPER: {}}
# xlstm's gradients at these weights are ill-conditioned: a change of 1e-7
# of every weight (about one float32 rounding) moves them by up to 2.1e-4
# of their scale (at S = 24; 3.6e-4 at S = 20), the mLSTM normaliser
# max(|q . n|, exp(-m)) dividing by sums that come near zero, so two
# float32 lowerings can differ by that much; the others move by < 1e-6
GRAD_TOL = {RGEMMA: 1e-4, XLSTM: 1e-3, WHISPER: 1e-4}


@functools.lru_cache(maxsize=None)
def _setups():
    """Per case: ``repro``'s config, the port's, ``repro``'s parameter
    tree with numpy draws N(0, 0.1^2) on every leaf (shapes from
    ``jax.eval_shape``), a batch (whisper's with its stub frames), and
    ``repro``'s loss, metrics and gradients, compiled as one XLA program
    at its lowest backend optimization level."""
    cases = {}
    for arch, kw in CASES.items():
        cfg = jget(arch).replace(dtype="float32", **kw)
        tcfg = tget(arch).replace(dtype="float32", **kw)
        shapes = jax.eval_shape(lambda c=cfg: build_model(c).init(
            jax.random.PRNGKey(0)))
        rng = np.random.RandomState(1)
        tree = jax.tree.map(lambda s: (0.1 * rng.randn(*s.shape)).astype(
            np.float32), shapes)
        batch = SyntheticLM(tcfg, batch=B, seq=S, seed=3)(0)
        cases[arch] = (cfg, tcfg, tree, batch)
    fns = [jax.value_and_grad(jts.make_loss_fn(c[0]), has_aux=True)
           for c in cases.values()]
    args = [(jax.tree.map(jnp.asarray, tree), _jbatch(batch))
            for _, _, tree, batch in cases.values()]
    outs = _compile(lambda *a: [f(*x) for f, x in zip(fns, a)], *args)(
        *args)
    return {arch: (*cases[arch], metrics, grads)
            for arch, ((_, metrics), grads) in zip(cases, outs)}


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


@pytest.mark.parametrize("arch", list(CASES))
def test_loss_and_grads_match_jax_grad(arch):
    _, tcfg, tree, batch, jm, jgrads = _setups()[arch]
    state = ts.init_state(tcfg, adamw.AdamWConfig(),
                          model=from_jax_params(tree, tcfg, device="cpu"))
    _, m, grads = ts.make_train_step(tcfg, adamw.AdamWConfig()).grads(
        state, batch)
    for key in ("loss", "nll", "moe_aux"):
        _close(m[key], jm[key], 1e-5, key)
    want = {n: p.detach().numpy() for n, p in from_jax_params(
        jax.tree.map(np.array, jgrads), tcfg, device="cpu").named_parameters()}
    leaves = ts.param_leaves(state["model"], tcfg)
    names = {id(p): n for n, p in state["model"].named_parameters()}
    got = {names[id(t)]: g.numpy() for leaf, gs in zip(leaves, grads)
           for t, g in zip(leaf.tensors, gs)}
    assert set(got) == set(want)
    for name in want:
        _close(got[name], want[name], GRAD_TOL[arch], name)


def test_encdec_leaves_are_repro_paths():
    """whisper's leaves are ``repro``'s tree paths (a decoder block's
    ``self``, not the port's ``self_attn``), stacked over each stack's
    layers with the stacked rank: each names a leaf of ``repro``'s tree
    of that rank."""
    _, tcfg, tree, _, _, _ = _setups()[WHISPER]
    model = from_jax_params(tree, tcfg, device="cpu")
    leaves = ts.param_leaves(model, tcfg)
    assert len({leaf.name for leaf in leaves}) == len(leaves)
    assert sum(len(leaf.tensors) for leaf in leaves) == len(
        list(model.parameters()))
    for leaf in leaves:
        node = tree
        for part in leaf.name.split("/"):
            node = node[part]
        assert np.ndim(node) == leaf.rank, leaf.name
    assert any(leaf.name.startswith("dec_blocks/self/") for leaf in leaves)


# ---------------------------------------------------------------------------
# each cell's block alone
# ---------------------------------------------------------------------------
D, W = 32, 48


def _cell(kind):
    """(repro's init of one cell, the port's cell with those weights, the
    repro block function, the port's) at width 32, block 16."""
    jc, tc = (CompressionConfig(enabled=True, block_ffn=16),
              TComp(enabled=True, block_ffn=16))
    key = jax.random.PRNGKey(4)
    cpu = torch.device("cpu")
    if kind == "rec":
        params = jrec.init_rglru(key, D, W, jc)
        cell = trec.RGLRU(D, W, tc, device=cpu)
        jfn = lambda p, x: jrec.rglru_block(  # noqa: E731
            p, x, width=W, comp=jc, mode="train")[0]
        tfn = lambda x: trec.rglru_block(cell, x, mode="train")[0]  # noqa
    elif kind == "mlstm":
        params = jrec.init_mlstm(key, D, 2, 2.0, jc)
        cell = trec.MLSTMCell(D, 2, 2.0, tc, device=cpu)
        jfn = lambda p, x: jrec.mlstm_block(  # noqa: E731
            p, x, heads=2, proj_factor=2.0, comp=jc, mode="train",
            chunk=8)[0]
        tfn = lambda x: trec.mlstm_block(  # noqa: E731
            cell, x, heads=2, mode="train", chunk=8)[0]
    else:
        params = jrec.init_slstm(key, D, 2, jc)
        cell = trec.SLSTMCell(D, tc, device=cpu)
        jfn = lambda p, x: jrec.slstm_block(  # noqa: E731
            p, x, comp=jc, mode="train")[0]
        tfn = lambda x: trec.slstm_block(cell, x, mode="train")[0]  # noqa
    convert._copy_into(cell, jax.tree.map(np.asarray, params), None, kind)
    return params, cell, jfn, tfn


@pytest.mark.parametrize("kind", ["rec", "mlstm", "slstm"])
def test_cell_block_grads_match_vjp(kind):
    """The cell's train-mode block over 24 positions (the mLSTM in three
    chunks of 8, its state carried; the sLSTM's host loop; the RG-LRU's
    doubling scan): the output within 1e-5 and the gradients of the input
    and of every cell parameter within 1e-4 of their scale against
    ``jax.vjp`` of ``repro``'s block, on ``repro``'s init."""
    params, cell, jfn, tfn = _cell(kind)
    rng = np.random.RandomState(9)
    x = rng.randn(2, S, D).astype(np.float32)
    g = rng.randn(2, S, D).astype(np.float32)
    def ref(p, xx, gg):
        out, vjp = jax.vjp(jfn, p, xx)
        return out, vjp(gg)
    args = (params, jnp.asarray(x), jnp.asarray(g))
    want, (jgp, jgx) = _compile(ref, *args)(*args)
    cell.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tfn(xt)
    got.backward(torch.from_numpy(g))
    _close(got.detach().numpy(), want, 1e-5, "out")
    _close(xt.grad.numpy(), jgx, 1e-4, "dx")
    grads = {n: p.grad.numpy() for n, p in cell.named_parameters()}
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(jgp)[0]}
    assert set(flat) == {n.replace(".", "/") for n in grads}
    for name, gr in grads.items():
        _close(gr, flat[name.replace(".", "/")], 1e-4, name)


# ---------------------------------------------------------------------------
# train-mode attention: the window, non-causal, softcap
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal,window,softcap,skv", [
    (True, 5, 0.0, 19), (True, 5, 50.0, 19), (False, 0, 0.0, 19),
    (False, 0, 0.0, 11)])
def test_masked_attention_matches_chunked(causal, window, softcap, skv):
    """``masked_attention`` (one chunk) against ``repro``'s
    ``chunked_attention`` at query chunks of 4 and key chunks of 8 (so
    the window skips whole key chunks): outputs within 1e-5, and the
    gradients of q, k and v within 1e-4 of their scale (summation order
    differs).  GQA (4 query heads over 2); Skv = 11 is cross-attention's
    shape (keys not the queries')."""
    rng = np.random.RandomState(13)
    q = rng.randn(2, 19, 4, 8).astype(np.float32)
    k = rng.randn(2, skv, 2, 8).astype(np.float32)
    v = rng.randn(2, skv, 2, 8).astype(np.float32)
    g = rng.randn(2, 19, 4, 8).astype(np.float32)
    def ref(a, b, c, gg):
        out, vjp = jax.vjp(lambda *t: jattn.chunked_attention(
            *t, causal=causal, window=window, softcap=softcap, q_chunk=4,
            kv_chunk=8), a, b, c)
        return out, vjp(gg)
    args = tuple(map(jnp.asarray, (q, k, v, g)))
    want, jg = _compile(ref, *args)(*args)
    ts_ = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    rows = torch.arange(19).expand(2, 19)
    kvpos = torch.arange(skv).expand(2, skv)
    got = tattn.masked_attention(*ts_, rows, kvpos, causal=causal,
                                 window=window, softcap=softcap)
    got.backward(torch.from_numpy(g))
    _close(got.detach().numpy(), want, 1e-5, "o")
    for t, ref, name in zip(ts_, jg, "qkv"):
        _close(t.grad.numpy(), ref, 1e-4, name)


# ---------------------------------------------------------------------------
# remat, the launcher, checkpoints
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", [RGEMMA, WHISPER])
def test_remat_equals_no_remat(arch):
    """Every group (recurrentgemma) or encoder and decoder layer (whisper,
    the cross K/V a checkpointed layer's inputs) under ``checkpoint``
    gives the same loss and gradients, bit for bit, as without."""
    _, tcfg, tree, batch, _, _ = _setups()[arch]
    out = []
    for remat in ("none", "full"):
        cfg = tcfg.replace(remat=remat)
        state = ts.init_state(cfg, adamw.AdamWConfig(),
                              model=from_jax_params(tree, cfg, device="cpu"))
        out.append(ts.make_train_step(cfg, adamw.AdamWConfig()).grads(
            state, batch))
    for a, b in zip([out[0][0]] + [g for gs in out[0][2] for g in gs],
                    [out[1][0]] + [g for gs in out[1][2] for g in gs]):
        assert torch.equal(a, b)


def test_launch_train_whisper_on_cpu(tmp_path):
    """The launcher on the encoder-decoder: the data's stub frames reach
    the encoder (its position table and first block take gradients)."""
    from repro_torch.launch import train
    out = train.main(["--arch", WHISPER, "--device", "cpu", "--steps", "2",
                      "--batch", "2", "--seq", "24", "--workdir",
                      str(tmp_path)])
    assert int(out["state"]["step"]) == 2
    assert int(out["state"]["skipped"]) == 0
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    first = {n: float(m["m"][0].abs().max()) for n, m in zip(
        [leaf.name for leaf in ts.param_leaves(
            out["state"]["model"], tget(WHISPER))],
        out["state"]["opt"]["mv"])}
    assert first["enc_pos/pos"] > 0 and first["enc_blocks/attn/q/wc"] > 0


def test_encdec_checkpoint_resume_is_bit_equal(tmp_path):
    """whisper: 2 steps, a checkpoint, a new trainer that restores it and
    takes steps 3 and 4, against 4 uninterrupted steps: every tensor of
    the two states equal."""
    tcfg = tget(WHISPER).replace(dtype="float32")
    data = SyntheticLM(tcfg, batch=B, seq=16, seed=0)
    opt = adamw.AdamWConfig(lr=1e-3)

    def trainer(workdir, steps):
        return Trainer(tcfg, opt, workdir=str(workdir), data_fn=data,
                       total_steps=steps, ckpt_every=2, device="cpu")
    whole = trainer(tmp_path / "a", 4).run()
    trainer(tmp_path / "b", 2).run()
    resumed = trainer(tmp_path / "b", 4)
    assert int(resumed.init_or_restore()["step"]) == 2
    state = resumed.run()
    pairs = list(zip(ckpt.named_tensors(whole), ckpt.named_tensors(state)))
    assert any("dec_blocks" in n for (n, _), _ in pairs)
    for (n, x), (_, y) in pairs:
        assert torch.equal(x, y), n
