"""The continuous engine's paged decode loop as one step over static
buffers (``serve/decode.py:make_paged_decode_loop``), against ``repro``'s
``make_paged_decode_loop`` (its ``lax.while_loop``) on the same weights,
pool, table and slot state (smoke tinyllama, float32).

On the CPU the step runs eagerly.  Tokens, positions, budgets, ``done``
and ``anom`` must be identical to ``repro``'s, across two dispatches that
carry the state: EOS, budgets ending inside a chunk, an idle slot and a
stalled one (budget 0 with pages), and the NaN guard.  The pool after the
dispatches is held at 1e-4 of its scale (float32 K/V computed in another
order; int8 codes within one step).  Sampled tokens cannot equal
``jax.random``'s (ROADMAP C): they are held bit for bit to the host loop
the port ran before the step was restructured, and the sampled run's
positions and budgets to ``repro``'s.

The tests marked ``cuda`` run on the card: the step replayed from its
CUDA graph is bit-equal to the same step run eagerly on every pool lane
(every page but the trash page, whose writes are unordered),
greedy and sampled; launch counts stay exact under replay; the step makes
no synchronizing call; and a capture that fails raises.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

# the reference: the card's machine has no JAX, and the ``cuda`` tests
# below need none
try:
    import jax  # noqa: E402
    import jax.numpy as jnp  # noqa: E402

    from repro.configs.registry import get_smoke_config  # noqa: E402
    from repro.models.registry import build_model  # noqa: E402
    from repro.serve import decode as jdec  # noqa: E402
    from repro.serve.params import precompute_serving_params as jbake  # noqa: E402,E501
except ImportError:
    jax = None

from repro_torch.configs.registry import get_smoke_config as tget  # noqa: E402
from repro_torch.kernels import build as tbuild  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.registry import build_model as tbuild_model  # noqa: E402
from repro_torch.quant import codec as tq  # noqa: E402
from repro_torch.serve import decode as tdec  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve import kvcache as tkv  # noqa: E402
from repro_torch.serve.params import precompute_serving_params as tbake  # noqa: E402

ARCH = "tinyllama-1.1b"
PAGE, MAXP, CHUNK = 4, 6, 4
# 4 slots: one decoding past the chunk, one whose budget ends inside the
# first chunk, an idle slot (trash-page table row) and a stalled one (a
# budget of 0 with pages of its own)
POS = np.array([9, 5, -1, 7], np.int32)
REM = np.array([10, 3, 0, 0], np.int32)
TABLE = np.array([[1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 11, 12],
                  [0, 0, 0, 0, 0, 0], [13, 14, 15, 16, 17, 18]], np.int32)
NUM_PAGES = 19


@pytest.fixture(scope="module")
def setup():
    if jax is None:
        pytest.skip("needs jax and repro (the reference)")
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    tcfg = tget(ARCH).replace(dtype="float32")
    params = jbake(build_model(cfg).init(jax.random.PRNGKey(0)), cfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                            device="cpu")
    return cfg, tcfg, params, model


def _pool_values(tcfg, kv_dtype, seed=0):
    """Random pool contents: K/V of the scale a prefill writes, int8 codes
    with page scales for an int8 pool.  Both packages lay a tinyllama pool
    out alike: (layers, pages, page, kv heads, head dim), scales (layers,
    pages, kv heads)."""
    rng = np.random.RandomState(seed)
    shapes = tkv.build_pool(tcfg, NUM_PAGES, PAGE, tq.QuantPolicy(kv_dtype),
                            device="cpu")
    vals = {}
    for key, t in shapes.items():
        if key.endswith("_scale"):
            vals[key] = rng.uniform(0.01, 0.03, t.shape).astype(np.float32)
        elif t.dtype == torch.int8:
            vals[key] = rng.randint(-127, 128, t.shape).astype(np.int8)
        else:
            vals[key] = rng.randn(*t.shape).astype(np.float32)
    return vals


def _port_pool(tcfg, kv_dtype, device="cpu"):
    pool = tkv.build_pool(tcfg, NUM_PAGES, PAGE, tq.QuantPolicy(kv_dtype),
                          device=device)
    for key, v in _pool_values(tcfg, kv_dtype).items():
        pool[key].copy_(torch.from_numpy(v))
    return pool


def _pools(tcfg, kv_dtype):
    """The same pool for ``repro`` (one segment of one block kind) and the
    port."""
    vals = _pool_values(tcfg, kv_dtype)
    return ([({k: jnp.asarray(v) for k, v in vals.items()},)],
            _port_pool(tcfg, kv_dtype))


def _start(cur_seed=1):
    cur = np.random.RandomState(cur_seed).randint(1, 500, 4).astype(np.int32)
    return cur, POS.copy(), REM.copy()


def _run_repro(cfg, params, jpool, cur, pos, rem, dispatches=2, **kw):
    loop = jax.jit(jdec.make_paged_decode_loop(cfg, CHUNK, **kw))
    outs = []
    state = (jnp.asarray(cur), jnp.asarray(pos), jnp.asarray(rem))
    for _ in range(dispatches):
        buf, c, jpool, p, r, done, anom, _ = loop(
            params, state[0], jpool, jnp.asarray(TABLE), state[1], state[2])
        outs.append({k: np.asarray(v) for k, v in dict(
            buf=buf, cur=c, pos=p, rem=r, done=done, anom=anom).items()})
        state = (c, p, r)
    return outs, jpool


def _run_port(tcfg, model, tpool, cur, pos, rem, dispatches=2, loop=None,
              table=TABLE, **kw):
    loop = loop or tdec.make_paged_decode_loop(tcfg, CHUNK, **kw)
    dev = tpool["k"].device
    outs = []
    state = tuple(torch.from_numpy(a).to(dev) for a in (cur, pos, rem))
    with torch.no_grad():
        for _ in range(dispatches):
            buf, c, tpool, p, r, done, anom, steps = loop(
                model, state[0], tpool, torch.from_numpy(table).to(dev),
                state[1], state[2])
            outs.append({k: v.cpu().numpy() for k, v in dict(
                buf=buf, cur=c, pos=p, rem=r, done=done,
                anom=anom).items()})
            outs[-1]["steps"] = steps
            state = (c, p, r)
    return outs, tpool


def _same_state(got, want, keys=("buf", "cur", "pos", "rem", "done",
                                 "anom")):
    for g, w in zip(got, want):
        for key in keys:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def _close_pool(tpool, jpool, kv_dtype):
    for key, t in tpool.items():
        want = np.asarray(jpool[0][0][key])
        got = t.float().numpy()
        if t.dtype == torch.int8:      # codes from K/V 1e-6 apart
            assert np.abs(got - want).max() <= 1
        else:
            tol = 1e-4 * max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _eos_of(tcfg, model, kv_dtype):
    """A token the first slot emits at its second step without EOS: with
    it as ``eos_id`` that slot stops inside the first chunk."""
    tpool = _port_pool(tcfg, kv_dtype)
    outs, _ = _run_port(tcfg, model, tpool, *_start(), dispatches=1)
    return int(outs[0]["buf"][0, 1])


@pytest.mark.parametrize("eos", [False, True])
@pytest.mark.parametrize("kv_dtype,impl", [("f32", "stream"),
                                           ("f32", "gather"),
                                           ("int8", "stream"),
                                           ("int8", "gather")])
def test_paged_loop_matches_repro(setup, kv_dtype, impl, eos):
    cfg, tcfg, params, model = setup
    eos_id = _eos_of(tcfg, model, kv_dtype) if eos else None
    jpool, tpool = _pools(tcfg, kv_dtype)
    want, jpool = _run_repro(cfg, params, jpool, *_start(), eos_id=eos_id,
                             paged_impl=impl)
    got, tpool = _run_port(tcfg, model, tpool, *_start(), eos_id=eos_id,
                           paged_impl=impl)
    _same_state(got, want)
    _close_pool(tpool, jpool, kv_dtype)
    # the idle and the stalled slot never advance; slot 1's budget of 3
    # ends inside the first chunk; with EOS slot 0 stops at its 2nd token
    last = got[-1]
    assert last["pos"][2] == -1 and last["pos"][3] == 7
    assert last["rem"][1] == 0 and got[0]["pos"][1] == 8
    if eos:
        assert got[0]["done"][0] and list(got[0]["buf"][0, 2:]) == [eos_id] * 2
    else:
        assert [o["steps"] for o in got] == [CHUNK, CHUNK]


def test_nan_guard_matches_repro(setup):
    """Slot 0's first page holds a NaN key: its logits are not finite, so
    it is flagged in ``anom`` at its first step, appends nothing and
    freezes; slot 1 (a table of its own pages) decodes on to its budget;
    then the loop ends early."""
    cfg, tcfg, params, model = setup
    cur, pos, _ = _start()
    rem = np.array([5, 2, 0, 0], np.int32)
    jpool, tpool = _pools(tcfg, "f32")
    jpool[0][0]["k"] = jpool[0][0]["k"].at[:, 1, 0].set(jnp.nan)
    tpool["k"][:, 1, 0] = float("nan")
    want, _ = _run_repro(cfg, params, jpool, cur, pos, rem, dispatches=1)
    got, _ = _run_port(tcfg, model, tpool, cur, pos, rem, dispatches=1)
    _same_state(got, want)
    g = got[0]
    assert list(g["anom"]) == [True, False, False, False]
    assert g["pos"][0] == 9 and g["rem"][0] == 5 and g["buf"][0, 0] == 0
    assert g["rem"][1] == 0 and g["steps"] == 2


def _host_loop(tcfg, chunk, params, cur, pool, table, pos, rem, *,
               temperature, seed):
    """The port's paged loop before its step ran over static buffers (a
    host loop of tensors made anew each step), sampling, no EOS: the
    reference the restructured loop's sampled tokens are held to."""
    model = tbuild_model(tcfg)
    B = cur.shape[0]
    slots = torch.arange(B)
    done = rem <= 0
    anom = torch.zeros(B, dtype=torch.bool)
    buf = torch.zeros((B, chunk), dtype=torch.int32)
    for j in range(chunk):
        if bool(done.all()):
            break
        masked = torch.where(done, torch.full_like(pos, -1), pos)
        logits, pool = model.decode_step(params, cur[:, None], pool, masked,
                                         block_table=table)
        last = logits[:, -1]
        finite = torch.isfinite(last).all(dim=-1)
        nxt = tdec.sample_tokens(last, temperature, seed, slots,
                                 torch.clamp(masked, min=0))
        bad = ~done & ~finite
        halt = done | bad
        buf[:, j] = torch.where(halt, torch.zeros_like(nxt), nxt)
        pos = torch.where(halt, pos, pos + 1)
        rem = torch.where(halt, rem, rem - 1)
        cur = torch.where(halt, cur, nxt)
        done = halt | (rem <= 0)
        anom = anom | bad
    return buf, cur, pos, rem, done, anom


def test_sampling_matches_host_loop_and_repro_state(setup):
    cfg, tcfg, params, model = setup
    cur, pos, rem = _start()
    tpool, ref_pool = _port_pool(tcfg, "f32"), _port_pool(tcfg, "f32")
    got, tpool = _run_port(tcfg, model, tpool, cur, pos, rem, dispatches=1,
                           sample=True, temperature=0.7, seed=3)
    with torch.no_grad():
        ref = _host_loop(tcfg, CHUNK, model, torch.from_numpy(cur), ref_pool,
                         torch.from_numpy(TABLE), torch.from_numpy(pos),
                         torch.from_numpy(rem), temperature=0.7, seed=3)
    for key, t in zip(("buf", "cur", "pos", "rem", "done", "anom"), ref):
        np.testing.assert_array_equal(got[0][key], t.numpy(), err_msg=key)
    for key in ("k", "v"):
        assert torch.equal(tpool[key], ref_pool[key])
    jpool, _ = _pools(tcfg, "f32")
    want, _ = _run_repro(cfg, params, jpool, cur, pos, rem, dispatches=1,
                         sample=True, temperature=0.7, seed=3)
    _same_state(got, want, keys=("pos", "rem", "done", "anom"))
    # another seed draws other tokens
    tpool = _port_pool(tcfg, "f32")
    other, _ = _run_port(tcfg, model, tpool, cur, pos, rem, dispatches=1,
                         sample=True, temperature=0.7, seed=4)
    assert not np.array_equal(other[0]["buf"], got[0]["buf"])


def test_decode_slots_stage_and_idle():
    st = tdec.DecodeSlots(3, 4, 2, torch.device("cpu"), fill=7)
    table = torch.tensor([[1, 2], [3, 4], [0, 0]], dtype=torch.int32)
    st.buf.fill_(1)
    st.j.fill_(3)
    st.stage(torch.tensor([5, 6, 8]), torch.tensor([2, 0, -1]),
             torch.tensor([1, 0, 4]), table)
    assert st.done.tolist() == [False, True, False]
    assert st.buf.eq(7).all() and int(st.j) == 0
    assert torch.equal(st.table, table) and st.table is not table
    st.idle()
    assert st.done.all() and st.pos.eq(-1).all() and st.table.eq(0).all()


def test_graph_capture_needs_a_cuda_device(setup):
    _, tcfg, _, model = setup
    loop = tdec.make_paged_decode_loop(tcfg, CHUNK, graphs=True)
    pool = tkv.build_pool(tcfg, NUM_PAGES, PAGE, device="cpu")
    with pytest.raises(ValueError, match="CUDA graph needs a CUDA device"):
        loop.slots(model, pool, 4, MAXP)


def test_engine_on_cpu_runs_the_step_eagerly(setup):
    _, tcfg, _, model = setup
    eng = teng.ContinuousEngine(tcfg, model, max_slots=2, max_seq=24,
                                page_size=PAGE, decode_chunk=CHUNK,
                                device="cpu")
    eng.generate([teng.Request(prompt=np.arange(1, 9, dtype=np.int32),
                               max_new_tokens=6)])
    st = eng.stats()
    assert st["decode_graphs"] == 0 and st["decode_steps"] == 5
    assert eng._slots.graph is None


def test_launch_record_counts_replays(monkeypatch):
    """Launches inside ``setup`` count apart; the record keeps them and
    each ``replayed`` adds them per lane and per plan path."""
    k = tbuild.Kernel("fake", {"f": [], "g": []})

    class Lib:
        f = g = staticmethod(lambda stream: 0)

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(k, "lib", lambda: Lib)
    monkeypatch.setattr(tbuild.torch.cuda, "current_stream",
                        lambda device=None: Stream)
    k.launch("f", None, path="a")
    rec = tbuild.LaunchRecord()
    with tbuild.setup():
        k.launch("g", None)
        with tbuild.setup(rec):
            k.launch("f", None, path="a")
            k.launch("f", None, path="b")
    assert (k.launches, k.setup_launches, rec.total) == (1, 3, 2)
    rec.replayed(3)
    assert k.launches == 7 and k.fn_launches == {"f": 7, "g": 0}
    assert k.path_launches == {"a": 4, "b": 3}
    k.reset_counts()
    assert (k.launches, k.setup_launches, k.path_launches) == (0, 0, {})


def test_launch_record_counts_shapes(monkeypatch):
    """A launch that names its shape counts in ``shape_launches``, eager
    and through a recorded graph's replays; one that names none does
    not."""
    k = tbuild.Kernel("fake", {"f": []})

    class Lib:
        f = staticmethod(lambda stream: 0)

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(k, "lib", lambda: Lib)
    monkeypatch.setattr(tbuild.torch.cuda, "current_stream",
                        lambda device=None: Stream)
    k.launch("f", None, path="a", shape="4x8")
    k.launch("f", None, path="a")
    rec = tbuild.LaunchRecord()
    with tbuild.setup(rec):
        k.launch("f", None, path="a", shape="1x8")
    rec.replayed(2)
    assert k.path_launches == {"a": 4}
    assert k.shape_launches == {"4x8": 1, "1x8": 2}
    k.reset_counts()
    assert k.shape_launches == {}


# ---------------------------------------------------------------------------
# on the card: replay against eager
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return tget(ARCH).replace(dtype="float32")


def _card_model(tcfg, seed=0):
    from repro_torch.models.transformer import init_params
    return tbake(init_params(tcfg, seed=seed, device="cuda"), tcfg)


@pytest.mark.cuda
@pytest.mark.parametrize("sample", [False, True])
@pytest.mark.parametrize("kv_dtype,impl", [("f32", "stream"),
                                           ("bf16", "stream"),
                                           ("f32", "gather"),
                                           ("int8", "stream")])
def test_replay_equals_eager_on_card(cuda, kv_dtype, impl, sample):
    tcfg = cuda
    model = _card_model(tcfg)
    runs = {}
    for graphs in (False, True):
        pool = _port_pool(tcfg, kv_dtype, device="cuda")
        loop = tdec.make_paged_decode_loop(tcfg, CHUNK, graphs=graphs,
                                           paged_impl=impl, sample=sample,
                                           seed=5)
        runs[graphs] = _run_port(tcfg, model, pool, *_start(), loop=loop)
        assert loop.captures == int(graphs)
    (eager, pe), (replay, pr) = runs[False], runs[True]
    _same_state(replay, eager)
    assert [o["steps"] for o in replay] == [o["steps"] for o in eager]
    for key in pe:                # but the trash page 0 (unordered writes)
        assert torch.equal(pe[key][:, 1:], pr[key][:, 1:]), key


@pytest.mark.cuda
def test_replay_launch_counts_exact(cuda):
    from repro_torch.kernels import bc_fused, paged_attention
    tcfg = cuda
    model = _card_model(tcfg)
    libs = (bc_fused.KERNEL, paged_attention.KERNEL)
    counts = {}
    for graphs in (False, True):
        pool = _port_pool(tcfg, "f32", device="cuda")
        loop = tdec.make_paged_decode_loop(tcfg, CHUNK, graphs=graphs)
        with torch.no_grad():
            loop.slots(model, pool, 4, MAXP)
        for lib in libs:
            lib.reset_counts()
        outs, _ = _run_port(tcfg, model, pool, *_start(), loop=loop)
        steps = sum(o["steps"] for o in outs)
        counts[graphs] = [(lib.fn_launches, lib.path_launches) for lib in libs]
        assert bc_fused.KERNEL.launches == 7 * tcfg.num_layers * steps
        assert paged_attention.KERNEL.launches == tcfg.num_layers * steps
        assert all(lib.setup_launches == 0 for lib in libs)
    assert counts[True] == counts[False]


@pytest.mark.cuda
def test_step_makes_no_sync_and_a_failed_capture_raises(cuda):
    tcfg = cuda
    model = _card_model(tcfg)
    pool = _port_pool(tcfg, "int8", device="cuda")
    loop = tdec.make_paged_decode_loop(tcfg, CHUNK, graphs=False)
    st = loop.slots(model, pool, 4, MAXP)
    st.stage(*(torch.from_numpy(a) for a in _start()),
             torch.from_numpy(TABLE))
    with torch.no_grad():
        loop.step(model, st, pool)           # cached constants
        torch.cuda.set_sync_debug_mode("error")
        try:
            loop.step(model, st, pool)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    bad = tdec.make_paged_decode_loop(tcfg, CHUNK, graphs=True)
    step = bad.step

    def syncing(params, st, pool):
        step(params, st, pool)
        bool(st.done.any())                  # a host read inside the step

    bad.step = syncing
    with torch.no_grad(), pytest.raises(RuntimeError):
        bad.slots(model, pool, 4, MAXP)
    assert bad.captures == 0
