"""The port's paged serving stack: page allocator and block table, prefill
packing against ``repro``'s, and the continuous engine's greedy tokens
against ``repro``'s ``ContinuousEngine`` on the same weights (smoke
tinyllama, float32), with slot recycling, preemption and EOS.

Greedy tokens must be identical: at float32 the two packages' logits
differ by ~3e-6 (``test_torch_model.py``), far below the top-1/top-2 gaps
of these runs.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_smoke_config  # noqa: E402
from repro.models.registry import build_model  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro.serve import kvcache as jkv  # noqa: E402
from repro_torch.configs.registry import get_smoke_config as tget  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.obs.metrics import Registry  # noqa: E402
from repro_torch.quant.codec import QuantPolicy  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve import kvcache as tkv  # noqa: E402

ARCH = "tinyllama-1.1b"


@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    tcfg = tget(ARCH).replace(dtype="float32")
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                            device="cpu")
    return cfg, tcfg, params, model


def _reqs(cls, specs, seed=0):
    rng = np.random.RandomState(seed)
    return [cls(prompt=rng.randint(1, 500, size=s).astype(np.int32),
                max_new_tokens=n, id=i) for i, (s, n) in enumerate(specs)]


def _both(setup, specs, **kw):
    cfg, tcfg, params, model = setup
    want = jeng.ContinuousEngine(cfg, params, **kw).generate(
        _reqs(jeng.Request, specs))
    eng = teng.ContinuousEngine(tcfg, model, device="cpu", **kw)
    return want, eng.generate(_reqs(teng.Request, specs)), eng


# ---------------------------------------------------------------------------
# host bookkeeping
# ---------------------------------------------------------------------------
def test_page_allocator_lifo_trash_and_double_free():
    reg = Registry()
    alloc = tkv.PageAllocator(6, registry=reg)
    assert alloc.available == 5 and alloc.alloc(2) == [1, 2]
    alloc.free([1])
    assert alloc.alloc(1) == [1]             # LIFO: the last freed comes back
    assert alloc.alloc(4) is None            # only 3 left
    with pytest.raises(ValueError, match="trash"):
        alloc.free([0])
    alloc.free([2])
    with pytest.raises(ValueError, match="double free"):
        alloc.free([2])
    with pytest.raises(ValueError, match="foreign"):
        alloc.free([9])
    assert reg.value("pool.free_pages") == alloc.available == 4
    assert reg.value("pool.pages_alloc") == 3
    assert reg.value("pool.pages_freed") == 2
    with pytest.raises(ValueError):
        tkv.PageAllocator(1)


def test_block_table_reserve_release():
    table = tkv.BlockTable(tkv.PageAllocator(6), max_slots=2, page_size=4,
                           max_pages_per_slot=3)
    assert table.reserve(0, 5) and table.pages(0) == [1, 2]
    v = table.version
    assert table.reserve(0, 8) and table.version == v   # already covered
    assert table.reserve(1, 9) and table.pages(1) == [3, 4, 5]
    assert not table.reserve(0, 12)          # pool exhausted: unchanged
    assert table.pages(0) == [1, 2]
    np.testing.assert_array_equal(table.table, [[1, 2, 0], [3, 4, 5]])
    with pytest.raises(ValueError, match="max_pages_per_slot"):
        table.reserve(0, 13)
    table.release(1)
    table.release(1)                         # idempotent
    assert table.table[1].tolist() == [0, 0, 0]
    assert table.utilization() == pytest.approx(2 / 5)
    dev = table.device_table("cpu")
    assert dev.dtype == torch.int32 and dev.shape == (2, 3)


def test_pack_prefill_cache_matches_repro(setup):
    cfg, tcfg, _, _ = setup
    rng = np.random.RandomState(3)
    page, P, spad = 4, 7, 12
    a = cfg.attention
    dense = {key: rng.randn(cfg.num_layers, 1, spad, a.num_kv_heads,
                            a.head_dim).astype(np.float32)
             for key in ("k", "v")}
    pages = np.array([5, 2, 6], np.int32)
    jdense = ({"k": jnp.asarray(dense["k"]), "v": jnp.asarray(dense["v"]),
               "pos": jnp.zeros((cfg.num_layers, spad), jnp.int32)},)
    ref = jkv.pack_prefill_cache(jkv.build_pool(cfg, P, page), [jdense],
                                 jnp.asarray(pages), page)
    for kv_dtype in ("f32", "bf16"):
        pool = tkv.build_pool(tcfg, P, page, QuantPolicy(kv_dtype),
                              device="cpu")
        got = tkv.pack_prefill_cache(
            pool, {k: torch.from_numpy(v) for k, v in dense.items()},
            torch.from_numpy(pages), page)
        assert got is pool                   # written in place
        for key in ("k", "v"):
            want = np.asarray(ref[0][0][key])
            if kv_dtype == "bf16":
                want = np.asarray(jnp.asarray(want).astype(jnp.bfloat16)
                                  .astype(jnp.float32))
            np.testing.assert_array_equal(got[key].float().numpy(), want)
    assert tkv.servable_reasons(tcfg) == []
    assert tkv.servable_reasons(tget("mixtral-8x7b"))


# ---------------------------------------------------------------------------
# the engine against repro's
# ---------------------------------------------------------------------------
def test_engine_matches_repro_with_recycling(setup):
    """More requests than slots, unaligned prompts, mixed budgets."""
    want, got, eng = _both(setup, [(20, 13), (12, 21), (16, 17), (9, 10),
                                   (23, 6)],
                           max_slots=2, max_seq=32, page_size=4,
                           decode_chunk=5)
    assert [g["tokens"] for g in got] == [w["tokens"] for w in want]
    assert [g["status"] for g in got] == ["FINISHED_BUDGET"] * 5
    st = eng.stats()
    assert st["pages_in_use"] == 0 and st["retired"] == 5
    assert st["tokens"] == 13 + 21 + 17 + 10 + 6
    assert st["prefills"] == 5 and st["decode_steps"] > 0


def test_engine_preemption_matches_repro(setup):
    """8 usable pages: decode-time growth preempts the younger slot, which
    recomputes its prefill; tokens stay identical."""
    want, got, eng = _both(setup, [(16, 12), (14, 12), (15, 10)],
                           max_slots=2, max_seq=32, page_size=4,
                           num_pages=9, decode_chunk=4)
    assert [g["tokens"] for g in got] == [w["tokens"] for w in want]
    st = eng.stats()
    assert st["preempted"] > 0 and any(g["preemptions"] for g in got)
    assert st["pages_in_use"] == 0 and st["tokens_in_flight"] == 0
    assert sum(st["statuses"].values()) == 3


def test_engine_eos_matches_repro(setup):
    cfg, tcfg, params, model = setup
    specs = [(16, 12), (12, 12)]
    base = teng.ContinuousEngine(tcfg, model, max_slots=2, max_seq=32,
                                 page_size=4, device="cpu").generate(
        _reqs(teng.Request, specs))
    eos = base[0]["tokens"][3]               # a token emitted mid-way
    want, got, eng = _both(setup, specs, max_slots=2, max_seq=32,
                           page_size=4, decode_chunk=4, eos_id=eos)
    assert [g["tokens"] for g in got] == [w["tokens"] for w in want]
    toks = got[0]["tokens"]
    assert toks[-1] == eos and eos not in toks[:-1] and len(toks) < 12
    assert got[0]["status"] == "FINISHED_EOS"
    assert eng.stats()["pages_in_use"] == 0


# ---------------------------------------------------------------------------
# lifecycle (port only)
# ---------------------------------------------------------------------------
def test_cancel_deadline_drain(setup):
    _, tcfg, _, model = setup
    reqs = _reqs(teng.Request, [(12, 8), (12, 8), (12, 8), (12, 8)])
    reqs[3] = dataclasses.replace(reqs[3], deadline_s=0.0)
    eng = teng.ContinuousEngine(tcfg, model, max_slots=1, max_seq=32,
                                page_size=4, decode_chunk=1, device="cpu")
    orders = [eng.submit(r) for r in reqs]
    eng.step()                               # admits + prefills request 0
    assert eng.result(orders[3])["status"] == "TIMEOUT"
    assert eng.cancel(reqs[1].id)            # queued: result now
    assert eng.result(orders[1])["status"] == "CANCELLED"
    assert eng.cancel(reqs[0].id)            # running: next boundary
    assert not eng.cancel(999)
    eng.drain()                              # sheds request 2 as REJECTED
    assert eng.result(orders[0])["status"] == "CANCELLED"
    assert eng.result(orders[2])["status"] == "REJECTED"
    st = eng.stats()
    assert st["pages_in_use"] == 0 and st["queue_depth"] == 0
    assert sum(st["statuses"].values()) == 4
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit(_reqs(teng.Request, [(40, 2)])[0])


def test_engine_refuses_params_on_another_device(setup):
    _, tcfg, _, model = setup
    with pytest.raises(ValueError, match="params are on"):
        teng.ContinuousEngine(tcfg, model, device="meta")
    with pytest.raises(NotImplementedError):
        teng.ContinuousEngine(tcfg, model, device="cpu", sample=True)


def test_launch_cli_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "tinyllama-1.1b", "--device", "cpu",
                "--requests", "3", "--new-tokens", "4", "--max-batch", "2"])
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out
    assert "statuses={'FINISHED_BUDGET': 3}" in out
