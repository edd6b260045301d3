"""The port's training stack against ``repro``'s on the CPU (smoke configs,
2 layers, float32, the same weights and the same numpy batch):

* the loss and every parameter's gradient of the four archs train mode
  runs, against ``jax.grad`` of ``repro``'s loss: ``repro``'s gradient tree
  is carried into a second model by ``from_jax_params`` and compared
  parameter by parameter (loss within 1e-5 of its scale, each gradient
  within 1e-4 of its own);
* one ``make_train_step`` step (AdamW, clipping, decay by ``repro``'s
  stacked rank) with float32 moments, int8 moments and int8 gradient
  compression: parameters within 1e-5 (a step moves them by about lr =
  1e-3; an element whose gradient is near AdamW's eps moves by a
  fraction of lr that follows its last bits; the decay of a scaled norm
  is 3e-5), moment scales within 1e-5 of
  theirs and int8 codes at most one step apart (a code rounds a value
  that differs in its last float32 bits); ``accum=2`` against ``accum=1``;
* the non-finite guard, ``kl_to_prior``, ``SyntheticLM``'s contract and the
  Bayesian sample's, checkpoints (round trip, resume, ``keep``), the
  launcher on the CPU.

The other block kinds and the encoder-decoder train in
``tests/test_torch_train_kinds.py`` and ``tests/test_torch_train_cells.py``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_smoke_config as jget  # noqa: E402
from repro.core import bayesian as jbayes  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models.registry import build_model  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import grad_compression as jgc  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.configs.registry import get_smoke_config as tget  # noqa: E402
from repro_torch.core import bayesian as tbayes  # noqa: E402
from repro_torch.core import circulant as tcc  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve.params import precompute_serving_params  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402

ARCHS = ("tinyllama-1.1b", "qwen2.5-3b", "qwen3-4b", "phi-3-vision-4.2b")
B, S = 2, 16


def _setup(arch):
    """``repro``'s parameter tree for the smoke config, filled with numpy
    draws N(0, 0.1^2) (every leaf, norm scales and biases included: zeros
    would hide a dropped leaf or a missing decay; its shapes come from
    ``jax.eval_shape``, so nothing is run), a batch, and ``repro``'s loss
    and gradients on them."""
    return _setups()[arch]


@functools.lru_cache(maxsize=None)
def _setups():
    """``_setup`` of every arch in ``ARCHS``, ``repro``'s four losses and
    gradients compiled as one program (shared by the tests: one compile
    costs less than four)."""
    cases = {}
    for arch in ARCHS:
        cfg = jget(arch).replace(dtype="float32")
        tcfg = tget(arch).replace(dtype="float32")
        shapes = jax.eval_shape(lambda: build_model(cfg).init(
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
    return {arch: (*cases[arch], loss, grads)
            for arch, ((loss, _), grads) in zip(cases, outs)}


def _compile(fn, *args):
    """``fn`` compiled by XLA at its lowest backend optimization level:
    the same operations, compiled in about half the time."""
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


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax_grad(arch):
    _, tcfg, tree, batch, jloss, jgrads = _setup(arch)
    state = ts.init_state(tcfg, adamw.AdamWConfig(),
                          model=from_jax_params(tree, tcfg, device="cpu"))
    loss, _, grads = ts.make_train_step(tcfg, adamw.AdamWConfig()).grads(
        state, batch)
    _close(loss, jloss, 1e-5, "loss")
    want = _params(from_jax_params(jax.tree.map(np.array, jgrads), tcfg,
                                   device="cpu"))
    leaves = ts.param_leaves(state["model"], tcfg)
    names = {id(p): n for n, p in state["model"].named_parameters()}
    got = {names[id(t)]: g.numpy() for leaf, gs in zip(leaves, grads)
           for t, g in zip(leaf.tensors, gs)}
    assert set(got) == set(want)
    for name in want:
        _close(got[name], want[name], 1e-4, name)


def _jstate_leaf(tree, name):
    node = tree
    for part in name.split("/"):
        node = node[int(part)] if isinstance(node, (list, tuple)) else \
            node[part]
    return node


STEP_CASES = {"f32": {}, "int8_moments": {"quantize_moments": True},
              "compress": {"compress_grads": True}}


def _repro_step(opt, tree, grads, compress):
    """``repro``'s step on its gradients, composed as its
    ``make_train_step`` composes it (compression, global norm, AdamW; the
    guard passes) from its own functions, so the model is compiled once."""
    def step(params, grads):
        state = {"params": params, "opt": jadamw.init(params, opt)}
        if compress:
            grads, state["ef"] = jgc.compress_decompress(
                grads, jgc.init_error_feedback(params))
        gnorm = jadamw.global_norm(grads)
        state["params"], state["opt"] = jadamw.update(
            grads, state["opt"], params, opt, opt.lr)
        return state, gnorm
    args = (jax.tree.map(jnp.asarray, tree), grads)
    return _compile(step, *args)(*args)


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_step_matches_repro(case):
    kw = dict(STEP_CASES[case])
    compress = kw.pop("compress_grads", False)
    _, tcfg, tree, batch, jloss, jgrads = _setup("tinyllama-1.1b")
    jstate, jgnorm = _repro_step(jadamw.AdamWConfig(lr=1e-3, **kw), tree,
                                 jgrads, compress)
    jm = {"loss": jloss, "grad_norm": jgnorm}
    topt = adamw.AdamWConfig(lr=1e-3, **kw)
    state = ts.init_state(tcfg, topt, compress_grads=compress,
                          model=from_jax_params(tree, tcfg, device="cpu"))
    step = ts.make_train_step(tcfg, topt, compress_grads=compress)
    _, _, grads = step.grads(state, batch)
    state, m = step(state, batch)
    _close(m["loss"], jm["loss"], 1e-5)
    _close(m["grad_norm"], jm["grad_norm"], 1e-5)
    assert int(state["skipped"]) == 0 and int(state["step"]) == 1
    want = _params(from_jax_params(jax.tree.map(np.array, jstate["params"]),
                                   tcfg, device="cpu"))
    for name, got in _params(state["model"]).items():
        np.testing.assert_allclose(got, want[name], rtol=0, atol=1e-5,
                                   err_msg=name)
    leaves = ts.param_leaves(state["model"], tcfg)
    for leaf, mv in zip(leaves, state["opt"]["mv"]):
        jmv = _jstate_leaf(jstate["opt"]["mv"], leaf.name)
        stack = lambda ts_: np.stack([t.numpy() for t in ts_]) \
            if len(ts_) > 1 or leaf.rank > leaf.tensors[0].dim() \
            else ts_[0].numpy()  # noqa: E731
        for key in ("m", "v"):
            got, ref = stack(mv[key]), np.asarray(jmv[key])
            if kw:                                    # int8 / uint8 codes
                assert got.dtype == ref.dtype
                assert np.abs(got.astype(np.int32)
                              - ref.astype(np.int32)).max() <= 1, leaf.name
                _close(mv[key + "_s"], jmv[key + "_s"], 1e-5, leaf.name)
            else:
                _close(got, ref, 1e-4, leaf.name)
    if compress:
        for leaf, ef, gs in zip(leaves, state["ef"], grads):
            ref = np.asarray(_jstate_leaf(jstate["ef"], leaf.name))
            got = np.stack([t.numpy() for t in ef]).reshape(ref.shape)
            # the residual of an int8 round trip: within one code (the
            # leaf's scale, absmax / 127) of repro's, as a value that
            # differs in its last bits may round to the next code
            code = max(float(g.abs().max()) for g in gs) / 127
            assert np.abs(got - ref).max() <= code * (1 + 1e-5), leaf.name


@pytest.mark.parametrize("accum,remat", [(2, "none"), (1, "full")])
def test_accum_and_remat_equal_plain(accum, remat):
    """Two microbatches of one row each give the one-batch mean (loss and
    every gradient within 1e-5 of their scale); ``remat="full"`` (each
    layer under ``checkpoint``, its forward run again in the backward)
    gives the same bits as no remat."""
    _, tcfg, tree, batch, _, _ = _setup("tinyllama-1.1b")
    out = []
    for a, r in ((1, "none"), (accum, remat)):
        cfg = tcfg.replace(remat=r)
        state = ts.init_state(cfg, adamw.AdamWConfig(),
                              model=from_jax_params(tree, cfg, device="cpu"))
        out.append(ts.make_train_step(cfg, adamw.AdamWConfig(),
                                      accum=a).grads(state, batch))
    exact = accum == 1
    assert exact or remat == "none"
    for got, ref in zip([out[1][0]] + [g for gs in out[1][2] for g in gs],
                        [out[0][0]] + [g for gs in out[0][2] for g in gs]):
        if exact:
            assert torch.equal(got, ref)
        else:
            _close(got.numpy(), ref.numpy(), 1e-5)


def test_non_finite_step_is_skipped():
    """A batch whose loss overflows keeps every parameter and moment and
    counts one skipped step, with no update of the moment count."""
    _, tcfg, tree, batch, _, _ = _setup("tinyllama-1.1b")
    opt = adamw.AdamWConfig(lr=1e-3)
    state = ts.init_state(tcfg, opt, model=from_jax_params(tree, tcfg,
                                                           device="cpu"))
    with torch.no_grad():
        state["model"].embed.table[int(batch["tokens"][0, 0])] = 3e38
    before = {n: t.clone() for n, t in _params_t(state["model"]).items()}
    state, m = ts.make_train_step(tcfg, opt)(state, batch)
    assert int(m["ok"]) == 0 and int(state["skipped"]) == 1
    assert int(state["opt"]["count"]) == 0 and int(state["step"]) == 1
    for n, t in _params_t(state["model"]).items():
        assert torch.equal(t, before[n]), n
    assert all(float(t.abs().max()) == 0 for mv in state["opt"]["mv"]
               for t in mv["m"])


def _params_t(model):
    return {n: p.detach() for n, p in model.named_parameters()}


def test_kl_to_prior_matches_repro():
    rng = np.random.RandomState(4)
    leaves = {"a": (rng.randn(3, 4), rng.randn(3, 4) - 3),
              "b": (rng.randn(5), rng.randn(5) - 5)}
    jtree = {n: {"mu": jnp.asarray(m, jnp.float32),
                 "rho": jnp.asarray(r, jnp.float32)}
             for n, (m, r) in leaves.items()}
    ttree = {n: {"mu": torch.tensor(m, dtype=torch.float32),
                 "rho": torch.tensor(r, dtype=torch.float32)}
             for n, (m, r) in leaves.items()}
    for sigma in (1.0, 0.3):
        _close(tbayes.kl_to_prior(ttree, sigma),
               jbayes.kl_to_prior(jtree, sigma), 1e-5)


def test_bayesian_sample_contract():
    """mean mu, standard deviation softplus(rho), from an explicit
    generator (the same bits from the same seed)."""
    mu = torch.full((200_000,), 0.5)
    rho = torch.full((200_000,), -1.0)
    tree = {"w": {"mu": mu, "rho": rho}}
    a = tbayes.sample(torch.Generator().manual_seed(0), tree)["w"]
    b = tbayes.sample(torch.Generator().manual_seed(0), tree)["w"]
    assert torch.equal(a, b)
    sd = float(torch.nn.functional.softplus(torch.tensor(-1.0)))
    assert abs(float(a.mean()) - 0.5) < 5 * sd / 200_000 ** .5
    assert abs(float(a.std()) - sd) < 0.01 * sd


def test_bayesian_step():
    """Bayesian mode: the loss is the sampled weights' plus KL /
    num_examples, ``mu`` and ``rho`` both take a step, and the same step
    index samples the same weights."""
    _, tcfg, tree, batch, _, _ = _setup("tinyllama-1.1b")
    opt = adamw.AdamWConfig(lr=1e-3)
    out = []
    for _ in range(2):
        state = ts.init_state(tcfg, opt, bayesian_mode=True,
                              model=from_jax_params(tree, tcfg, device="cpu"))
        step = ts.make_train_step(tcfg, opt, bayesian_mode=True,
                                  num_examples=1000)
        rho0 = {n: r.detach().clone() for n, r in state["rho"].items()}
        state, m = step(state, batch)
        out.append(m)
    assert int(state["skipped"]) == 0
    _close(m["loss"], m["nll"] + m["kl"] / 1000, 1e-6)
    assert float(out[0]["loss"]) == float(out[1]["loss"])
    assert all(not torch.equal(r, rho0[n]) for n, r in state["rho"].items())


def test_synthetic_lm_contract():
    """A pure function of (seed, step); labels are the next tokens; the
    bigram table is repro's; about 90% of steps follow it; the vision
    stub's patches are N(0, 0.02^2)."""
    cfg = tget("phi-3-vision-4.2b")
    data = SyntheticLM(cfg, batch=64, seq=64, seed=5)
    a, b = data(3), data(3)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["tokens"], data(4)["tokens"])
    assert not torch.equal(
        a["tokens"], SyntheticLM(cfg, batch=64, seq=64, seed=6)(3)["tokens"])
    assert a["tokens"].dtype == a["labels"].dtype == torch.int32
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    jdata = JSyntheticLM(jget("phi-3-vision-4.2b"), batch=2, seq=4, seed=5)
    np.testing.assert_array_equal(data._succ, jdata._succ)
    follows = (torch.from_numpy(data._succ)[a["tokens"].long()]
               == a["labels"]).float().mean()
    assert 0.88 < float(follows) < 0.93
    p = a["patches"]
    assert p.shape == (64, cfg.num_patches, cfg.d_model)
    assert abs(float(p.mean())) < 1e-3 and abs(float(p.std()) - 0.02) < 1e-3


def test_file_tokens_equal_repro_and_shard(tmp_path):
    """``FileTokens`` reads the same windows as ``repro``'s (its
    addressing has no random bits), and ``shard_for_host`` cuts a host's
    rows."""
    from repro.data.pipeline import FileTokens as JFileTokens
    from repro_torch.data.pipeline import FileTokens, shard_for_host
    path = tmp_path / "tokens.bin"
    np.arange(1000, dtype=np.uint16)[::-1].tofile(path)
    mine = FileTokens(tget("tinyllama-1.1b"), str(path), batch=4, seq=9,
                      seed=2)
    theirs = JFileTokens(jget("tinyllama-1.1b"), str(path), batch=4, seq=9,
                         seed=2)
    for step in (0, 7):
        a, b = mine(step), theirs(step)
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(a[key].numpy(), np.asarray(b[key]))
    half = shard_for_host(mine(0), 1, 2)
    assert torch.equal(half["tokens"], mine(0)["tokens"][2:])


def test_checkpoint_round_trip_resume_and_keep(tmp_path):
    """A state saved and restored into a fresh one is equal; a trainer
    resumed at step 2 ends equal to one that ran 4 steps; ``keep`` prunes;
    a corrupted file fails its check."""
    tcfg = tget("tinyllama-1.1b").replace(dtype="float32")
    data = SyntheticLM(tcfg, batch=B, seq=S, seed=0)
    opt = adamw.AdamWConfig(lr=1e-3, quantize_moments=True)

    def trainer(workdir, steps):
        return Trainer(tcfg, opt, workdir=str(workdir), data_fn=data,
                       total_steps=steps, ckpt_every=1, device="cpu")

    whole = trainer(tmp_path / "a", 4).run()
    trainer(tmp_path / "b", 2).run()
    resumed = trainer(tmp_path / "b", 4)
    state = resumed.init_or_restore()
    assert int(state["step"]) == 2
    state = resumed.run()
    for (n, x), (_, y) in zip(ckpt.named_tensors(whole),
                              ckpt.named_tensors(state)):
        assert torch.equal(x, y), n
    assert ckpt.latest_steps(str(tmp_path / "b" / "ckpt")) == [2, 3, 4]
    ckpt.save(str(tmp_path / "b" / "ckpt"), 5, state, keep=2)
    assert ckpt.latest_steps(str(tmp_path / "b" / "ckpt")) == [4, 5]
    fresh = ts.init_state(tcfg, opt, device="cpu", seed=9)
    fresh, step = ckpt.restore(str(tmp_path / "b" / "ckpt"), fresh, step=4)
    assert step == 4
    for (n, x), (_, y) in zip(ckpt.named_tensors(fresh),
                              ckpt.named_tensors(state)):
        assert torch.equal(x, y), n
    path = tmp_path / "b" / "ckpt" / "step_00000005" / "state.pt"
    raw = path.read_bytes()
    path.write_bytes(raw[:-1] + bytes([raw[-1] ^ 0xFF]))
    with pytest.raises(IOError):
        ckpt.restore(str(tmp_path / "b" / "ckpt"), fresh)
    assert Trainer.heartbeat_age(str(tmp_path / "a")) < 60


def test_trainer_saves_each_step_once(tmp_path, monkeypatch):
    """A run whose last step is a periodic checkpoint's does not save it
    again at the end."""
    from repro_torch.train import trainer as trainer_mod
    tcfg = tget("tinyllama-1.1b").replace(dtype="float32")
    saved = []
    real_save = trainer_mod.ckpt.save

    def save(ckpt_dir, step, state, **kw):
        saved.append(step)
        return real_save(ckpt_dir, step, state, **kw)
    monkeypatch.setattr(trainer_mod.ckpt, "save", save)
    Trainer(tcfg, adamw.AdamWConfig(), workdir=str(tmp_path),
            data_fn=SyntheticLM(tcfg, batch=B, seq=S, seed=0),
            total_steps=4, ckpt_every=2, device="cpu").run()
    assert saved == [2, 4]


def test_launch_train_on_cpu(tmp_path):
    from repro_torch.launch import train
    out = train.main(["--arch", "tinyllama-1.1b", "--device", "cpu",
                      "--steps", "2", "--batch", "2", "--seq", "16",
                      "--workdir", str(tmp_path)])
    assert int(out["state"]["step"]) == 2
    assert int(out["state"]["skipped"]) == 0
    reg = out["registry"]
    assert reg.value("train.steps") == 2
    assert reg.value("train.tokens") == 2 * 2 * 16
    assert np.isfinite(out["history"][0]["loss"])
    # --metrics-out streams the trainer's obs snapshots as JSONL
    from repro_torch.obs.emit import validate_jsonl
    path = str(tmp_path / "m.jsonl")
    train.main(["--arch", "tinyllama-1.1b", "--device", "cpu", "--steps",
                "1", "--batch", "2", "--seq", "16", "--ckpt-every", "0",
                "--workdir", str(tmp_path / "w"), "--metrics-out", path])
    assert validate_jsonl(path)["snapshot"] == 1


def test_train_path_never_reaches_flash(monkeypatch):
    """Train mode attends through the plain masked attention: the flash
    kernel (no backward) is never called."""
    def refuse(*a, **k):
        raise AssertionError("flash_attention on the train path")
    monkeypatch.setattr(tops, "flash_attention", refuse)
    _, tcfg, tree, batch, _, _ = _setup("qwen3-4b")
    state = ts.init_state(tcfg, adamw.AdamWConfig(),
                          model=from_jax_params(tree, tcfg, device="cpu"))
    ts.make_train_step(tcfg, adamw.AdamWConfig())(state, batch)


def test_trained_model_is_rebaked():
    """A step drops the baked planes; baking again gives the planes of the
    new generators."""
    _, tcfg, tree, batch, _, _ = _setup("tinyllama-1.1b")
    model = precompute_serving_params(from_jax_params(tree, tcfg,
                                                      device="cpu"), tcfg)
    old = model.blocks[0].attn.q.wc_cache["wr"].clone()
    state = ts.init_state(tcfg, adamw.AdamWConfig(lr=1e-2), model=model)
    ts.make_train_step(tcfg, adamw.AdamWConfig(lr=1e-2))(state, batch)
    assert model.blocks[0].attn.q.wc_cache is None
    precompute_serving_params(model, tcfg)
    for m in model.modules():
        if isinstance(m, tcc.Linear) and m.spec.kind == "block_circulant":
            want = tcc.spectral_cache(m.wc.detach())
            for key, t in m.wc_cache.items():
                assert torch.equal(t, want[key])
    assert not torch.equal(model.blocks[0].attn.q.wc_cache["wr"], old)
