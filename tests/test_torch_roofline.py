"""The port's roofline accounting (``repro_torch/roofline``) and dispatch
profiler (``repro_torch/obs/prof.py``) against ``repro``'s.

* ``model_flops_per_token``, ``count_params``,
  ``seq_mixer_flops_per_token`` and ``slstm_scan_correction`` equal
  ``repro``'s (relative 1e-12) on all ten smoke configs, from one set of
  weights carried across by ``models/convert.py``.
* The presets, ``bound`` and ``rfft_flops``; the report tables.
* The profiler's arithmetic equals ``repro``'s for the same counts and
  marks; the serving counts (``ServingCounts``) equal their definition.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax  # noqa: E402

    from repro.configs.base import ShapeSpec as JShape  # noqa: E402
    from repro.configs.registry import get_smoke_config  # noqa: E402
    from repro.models.registry import build_model  # noqa: E402
    from repro.obs import prof as jprof  # noqa: E402
    from repro.obs.metrics import Registry as JRegistry  # noqa: E402
    from repro.roofline import analysis as ja  # noqa: E402
    from repro.roofline import report as jreport  # noqa: E402
except ImportError:
    jax = None

from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS as T_ARCH_IDS  # noqa: E402
from repro_torch.configs.registry import get_smoke_config as tget  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.registry import init_params  # noqa: E402
from repro_torch.models.transformer import layer_kinds  # noqa: E402
from repro_torch.obs import prof  # noqa: E402
from repro_torch.obs.metrics import Registry  # noqa: E402
from repro_torch.quant import codec  # noqa: E402
from repro_torch.roofline import analysis as ta  # noqa: E402
from repro_torch.roofline import report  # noqa: E402
from repro_torch.serve.params import precompute_serving_params  # noqa: E402

SHAPES = [("train", 64, 4), ("prefill", 37, 2), ("decode", 300, 8),
          ("prefill", 1, 1)]


def _need_ref():
    if jax is None:
        pytest.skip("needs jax and repro (the reference)")


@pytest.mark.parametrize("arch", T_ARCH_IDS)
def test_counts_match_repro(arch):
    _need_ref()
    cfg, tcfg = get_smoke_config(arch), tget(arch)
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                            device="cpu")
    assert ta.model_flops_per_token(model, tcfg) == pytest.approx(
        ja.model_flops_per_token(params, cfg), rel=1e-12)
    assert ta.count_params(model) == ja.count_params(params)
    for kind, S, B in SHAPES:
        js, ts = JShape("c", S, B, kind), ShapeSpec("c", S, B, kind)
        assert ta.seq_mixer_flops_per_token(tcfg, ts) == pytest.approx(
            ja.seq_mixer_flops_per_token(cfg, js), rel=1e-12)
        for dp in (1, 2):
            assert ta.slstm_scan_correction(tcfg, ts, dp) == pytest.approx(
                ja.slstm_scan_correction(cfg, js, dp), rel=1e-12)
    # the walk reads the generators, not the baked planes
    precompute_serving_params(model, tcfg)
    assert ta.model_flops_per_token(model, tcfg) == pytest.approx(
        ja.model_flops_per_token(params, cfg), rel=1e-12)


def test_bc_flops_matches_repro():
    _need_ref()
    from repro.core import circulant as jcc
    for args in [(1, 2048, 2048, 128), (3, 100, 36, 16), (8, 64, 64, 1)]:
        for gauss in (True, False):
            assert ta.bc_flops(*args, gauss=gauss) == jcc.bc_flops(
                *args, gauss=gauss)


def test_presets_match_repro_and_add_the_h100():
    _need_ref()
    for name, spec in ja.HARDWARE_PRESETS.items():
        assert ta.HARDWARE_PRESETS[name].__dict__ == spec.__dict__
    h = ta.HARDWARE_PRESETS["h100"]
    assert (h.peak_flops, h.hbm_bw) == (989e12, 3.35e12)
    assert h.ridge_flops_per_byte == pytest.approx(989e12 / 3.35e12)
    assert ta.detect_hardware("cpu").name == "host-cpu"
    if not torch.cuda.is_available():
        assert ta.detect_hardware().name == "host-cpu"
    assert prof.resolve_hardware("h100") is h
    assert prof.resolve_hardware("auto") is None
    with pytest.raises(ValueError, match="unknown hardware"):
        prof.resolve_hardware("tpu-v9")


def test_bound_and_rfft_flops():
    ms, by = ta.bound(3.35e9, 1.0, torch.float32)
    assert ms == pytest.approx(1.0) and by == "bytes"
    ms, by = ta.bound(1.0, 67e9, torch.float32)
    assert ms == pytest.approx(1.0) and by == "operations"
    ms, by = ta.bound(1.0, 989e9, torch.bfloat16)
    assert ms == pytest.approx(1.0) and by == "operations"
    assert ta.rfft_flops(3, 128) == 2.5 * 3 * 128 * 7
    assert ta.rfft_flops(1, 64) == pytest.approx(2.5 * 64 * math.log2(64))


def test_report_tables_match_repro():
    _need_ref()
    coll = {"all-gather": 2 ** 30, "all-reduce": 0, "reduce-scatter": 3e8,
            "all-to-all": 0, "collective-permute": 5e7}
    recs = [
        {"arch": "a", "shape": "s", "mesh": "16x16", "status": "ok",
         "compute_s": 2e-4, "memory_s": 0.5, "collective_s": 3.0,
         "dominant": "collective_s", "model_hlo_ratio": 0.8,
         "roofline_frac_overlap": 0.123, "bytes_per_device": 3 * 2 ** 30,
         "flops_per_device": 1.5e12, "collectives": coll},
        {"arch": "b", "shape": "s", "mesh": "16x16", "status": "skipped",
         "why": "pure attention"},
        {"arch": "c", "shape": "t", "mesh": "16x16", "status": "error",
         "error": "boom" * 30},
    ]
    assert report.roofline_table(recs) == jreport.roofline_table(recs)
    assert report.dryrun_table(recs) == jreport.dryrun_table(recs)
    for x in (0, 5e-7, 2e-2, 3.5):
        assert report.fmt_s(x) == jreport.fmt_s(x)


class _Compiled:
    """What ``repro``'s profiler reads of an executable: its costs."""

    def __init__(self, flops, nbytes):
        self._ca = {"flops": flops, "bytes accessed": nbytes}

    def cost_analysis(self):
        return self._ca


def test_profiler_matches_repro():
    _need_ref()
    treg, jreg = Registry(), JRegistry()
    tp = prof.Profiler(treg, hardware=ta.HARDWARE_PRESETS["tpu-v5e"])
    jp = jprof.Profiler(jreg, hardware=ja.HARDWARE_PRESETS["tpu-v5e"])
    for p in (tp, jp):
        p.watch("pool.free_pages")
    marks = [(0.0, 0.003), (0.01, 0.0105), (0.02, 0.031), (0.04, 0.0401)]
    counts = [("prefill_2p", 3e9, 2e8), ("decode_chunk", 1e8, 9e8)]
    for i, (t0, t1) in enumerate(marks):
        kind, flops, nbytes = counts[i % 2]
        treg.gauge("pool.free_pages").set(10 - i)
        jreg.gauge("pool.free_pages").set(10 - i)
        tp.on_dispatch(tp.register(kind, flops, nbytes), t0, t1)
        jp.on_dispatch(jp.register(kind, _Compiled(flops, nbytes)), t0, t1)
    tp.on_dispatch(None, 0.5, 0.6)
    jp.on_dispatch(None, 0.5, 0.6)
    assert tp.summary() == jp.summary()
    assert list(tp.events) == list(jp.events)
    assert tp.samples == jp.samples
    assert treg.snapshot() == jreg.snapshot()
    cost = tp.costs["decode_chunk"]
    assert cost.bound == "memory" and cost.intensity == pytest.approx(1 / 9)
    # a disabled profiler logs nothing
    off = prof.Profiler(Registry(), enabled=False)
    off.on_dispatch(off.register("k", 1.0, 1.0), 0.0, 1.0)
    assert not off.events and off.summary()["k"]["dispatches"] == 0


def test_scoped_profiler_prefixes_kinds():
    base = prof.Profiler(Registry(), hardware=ta.HARDWARE_PRESETS["h100"])
    view = prof.ScopedProfiler(base, {"replica": "r0"})
    view.on_dispatch(view.register("decode_chunk", 1e9, 1e9), 0.0, 0.01)
    assert list(base.summary()) == ["r0:decode_chunk"]
    assert list(view.summary()) == ["decode_chunk"]
    assert view.spec.name == "h100"


def test_profiler_binds_the_engine_device():
    p = prof.Profiler(Registry())
    p.bind_device("cpu")
    assert p.spec.name == "host-cpu"
    fixed = prof.Profiler(Registry(), hardware=ta.HARDWARE_PRESETS["h100"])
    fixed.bind_device("cpu")
    assert fixed.spec.name == "h100"


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_serving_weight_bytes(bits):
    """Planes (scales included) plus every parameter but the generators
    the planes replace."""
    cfg = tget("tinyllama-1.1b")
    model = init_params(cfg, device="cpu")
    raw = sum(p.numel() * 4 for p in model.parameters())
    assert ta.serving_weight_bytes(model, cfg) == raw      # nothing baked
    policy = (codec.QuantPolicy(quant_weights=True, weight_bits=bits)
              if bits else None)
    precompute_serving_params(model, cfg, policy)
    gens = sum(p.numel() * 4 for n, p in model.named_parameters()
               if n.endswith(".wc"))
    planes = sum(t.numel() * t.element_size()
                 for _, _, _, c in codec.baked_caches(model)
                 for t in c.values())
    assert ta.serving_weight_bytes(model, cfg) == raw - gens + planes
    if bits:
        assert planes < gens * 3                # narrower than float32


def test_serving_weight_bytes_fused_and_experts():
    cfg = tget("llama4-maverick-400b-a17b").with_compression(
        fuse_projections=True)
    model = precompute_serving_params(init_params(cfg, device="cpu"), cfg)
    full = ta.serving_weight_bytes(model, cfg)
    one = ta.serving_weight_bytes(model, cfg, tokens=1)
    assert one < full
    # every generator is replaced by planes: fused q/k/v and up/gate too
    gens = sum(p.numel() * 4 for n, p in model.named_parameters()
               if n.endswith(".wc") or ".experts." in n)
    raw = sum(p.numel() * 4 for p in model.parameters())
    planes = sum(t.numel() * t.element_size()
                 for _, _, _, c in codec.baked_caches(model)
                 for t in c.values())
    assert full == raw - gens + planes


def test_serving_counts_definition():
    cfg = tget("tinyllama-1.1b")
    model = precompute_serving_params(init_params(cfg, device="cpu"), cfg)
    kv = 2 * cfg.attention.num_kv_heads * cfg.attention.head_dim
    c = ta.ServingCounts(model, cfg, kv)
    proj = ta.model_flops_per_token(model, cfg)
    w = ta.serving_weight_bytes(model, cfg)
    L = cfg.num_layers
    flops, nbytes = c.prefill([7, 12])
    want = sum(s * (proj + ta.seq_mixer_flops_per_token(
        cfg, ta.prefill_shape(s))) for s in (7, 12))
    assert flops == pytest.approx(want, rel=1e-12)
    assert nbytes == w + L * kv * 19
    ctx = [5, 6, 9, 30]
    flops, nbytes = c.decode(ctx, passes=3, rows=2)
    want = sum(proj + ta.seq_mixer_flops_per_token(
        cfg, ta.decode_shape(x)) for x in ctx)
    assert flops == pytest.approx(want, rel=1e-12)
    assert nbytes == 3 * w + L * kv * sum(ctx)


def test_serving_counts_windows():
    cfg = tget("gemma2-9b")
    model = init_params(cfg, device="cpu")
    c = ta.ServingCounts(model, cfg, 1.0)
    w = cfg.attention.sliding_window
    kinds = layer_kinds(cfg)
    n_local = kinds.count("attn_local")
    n_global = kinds.count("attn")
    big = 3 * w
    _, nbytes = c.decode([big], passes=0, rows=1)
    assert nbytes == n_local * w + n_global * big
