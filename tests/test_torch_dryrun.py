"""The port's dry run (``launch/dryrun.py``, ``roofline/analysis.py``'s cost
readers, ``models/registry.py``'s input specs, ``serve/params.py``'s
strip and byte count) against ``repro``'s.

* In this process: the input specs of all ten archs x four shapes at full
  size (batch leaves equal in shape and dtype, cache bytes equal in
  total, nothing allocated: fake tensors on the port's side,
  ``jax.eval_shape`` on ``repro``'s), the cells' statuses and skip
  reasons, ``model_flops`` and ``params`` of every cell that applies,
  and ``strip_serving_params`` / ``serving_cache_bytes`` on converted
  weights.
* In a subprocess (a fake process group of 8 ranks, and ``XLA_FLAGS``
  set to 8 host devices before ``jax`` loads; the suite's workers hold a
  one-rank gloo group already): ``repro``'s ``lower_cell`` and the
  port's on mixtral's smoke ``train_4k`` cell (``remat="none"``,
  ``accum=1``) and tinyllama's smoke ``decode_32k`` cell on a (2, 4)
  mesh, whose argument bytes must be equal, and the collectives of the
  latter by kind against a count by hand.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs.registry import get_config as jget  # noqa: E402
from repro.configs.registry import get_smoke_config as jsmoke  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.roofline import analysis as jroof  # noqa: E402
from repro.serve import params as jparams  # noqa: E402
from repro_torch.configs.base import ALL_SHAPES  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.roofline import analysis as troof  # noqa: E402
from repro_torch.serve import params as tparams  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _jbytes(tree) -> int:
    return sum(int(np.prod(s.shape)) * np.dtype(s.dtype).itemsize
               for s in jax.tree.leaves(tree))


def _tbytes(tree) -> int:
    return troof.local_bytes(tree)


def _dt(t) -> str:
    return str(t.dtype).split(".")[-1]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_repro(arch):
    """Every shape's inputs at full size: the batch leaves (and a decode
    step's tokens and position) equal ``repro``'s in shape and dtype, the
    cache's bytes in total; the port's are fake tensors."""
    from torch._subclasses.fake_tensor import is_fake
    jcfg, tcfg = jget(arch), get_config(arch)
    for shape in ALL_SHAPES:
        want = jreg.input_specs(jcfg, jbase.SHAPES_BY_NAME[shape.name])
        got = treg.input_specs(tcfg, shape)
        assert set(got) == set(want), shape.name
        for key in ("batch", "tokens", "cache_pos"):
            if key not in want:
                continue
            w = want[key] if key == "batch" else {key: want[key]}
            g = got[key] if key == "batch" else {key: got[key]}
            assert set(g) == set(w), (shape.name, key)
            for name in w:
                assert tuple(g[name].shape) == tuple(w[name].shape), name
                assert _dt(g[name]) == str(np.dtype(w[name].dtype)), name
                assert is_fake(g[name])
        if "cache" in want:
            assert _tbytes(got["cache"]) == _jbytes(want["cache"]), shape
            assert all(is_fake(t) for t in troof._tensors(got["cache"]))


def test_statuses_and_skip_reasons_match_repro():
    """All 40 cells: the same cells apply, and a skipped cell's record
    carries ``repro``'s status and reason (no mesh is touched)."""
    from repro_torch.configs.base import cell_is_applicable
    n_skip = 0
    for arch in ARCH_IDS:
        for shape in ALL_SHAPES:
            want = jbase.cell_is_applicable(
                jget(arch), jbase.SHAPES_BY_NAME[shape.name])
            assert cell_is_applicable(get_config(arch), shape) == want
            if not want[0]:
                rec = dryrun.run_cell(arch, shape.name, None, "16x16",
                                      "megatron")
                assert (rec["status"], rec["why"]) == ("skipped", want[1])
                n_skip += 1
    assert n_skip == 7                      # long_500k but three archs


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_params_match_repro(arch):
    """``cell_report``'s ``model_flops`` (``cell_model_flops``) and
    ``params`` against ``repro``'s formula (``model_flops_per_token`` +
    ``seq_mixer_flops_per_token`` over ``eval_shape`` of its init) for
    every cell that applies, the port's model built without allocation."""
    jcfg, tcfg = jget(arch), get_config(arch)
    shapes = jax.eval_shape(lambda: jreg.build_model(jcfg).init(
        jax.random.PRNGKey(0)))
    params = treg.abstract_params(tcfg)
    assert troof.count_params(params) == jroof.count_params(shapes)
    per_tok = jroof.model_flops_per_token(shapes, jcfg)
    for shape in ALL_SHAPES:
        jshape = jbase.SHAPES_BY_NAME[shape.name]
        if not jbase.cell_is_applicable(jcfg, jshape)[0]:
            continue
        fwd = per_tok + jroof.seq_mixer_flops_per_token(jcfg, jshape)
        tokens = jshape.global_batch * (1 if jshape.kind == "decode"
                                        else jshape.seq_len)
        want = fwd * tokens * (3.0 if jshape.kind == "train" else 1.0)
        got = troof.cell_model_flops(params, tcfg, shape)
        assert got == pytest.approx(want, rel=1e-12), shape.name


@pytest.mark.parametrize("bits", [None, 8])
def test_strip_and_serving_cache_bytes_match_repro(bits):
    """On converted weights: ``serving_cache_bytes`` of the baked (and
    int8-quantized) planes equals ``repro``'s, and ``strip_serving_params``
    leaves the generators as they were and no plane."""
    from repro.quant.codec import QuantPolicy as JPolicy
    from repro_torch.quant.codec import QuantPolicy
    cfg = jsmoke("tinyllama-1.1b").replace(dtype="float32")
    tcfg = get_smoke_config("tinyllama-1.1b").replace(dtype="float32")
    params = jreg.build_model(cfg).init(jax.random.PRNGKey(0))
    jpol = tpol = None
    if bits:
        jpol, tpol = JPolicy("int8", True, bits), QuantPolicy("int8", True,
                                                               bits)
    baked = jparams.precompute_serving_params(params, cfg, jpol)
    want = jparams.serving_cache_bytes(baked)
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                            device="cpu")
    before = {n: p.clone() for n, p in model.named_parameters()}
    tparams.precompute_serving_params(model, tcfg, tpol)
    assert want > 0 and tparams.serving_cache_bytes(model) == want
    carried = from_jax_params(jax.tree.map(np.asarray, baked), tcfg,
                              device="cpu")
    assert tparams.serving_cache_bytes(carried) == want
    assert tparams.strip_serving_params(model) is model
    assert tparams.serving_cache_bytes(model) == 0
    assert not [n for n, b in model.named_buffers() if b is not None]
    assert all(torch.equal(p, before[n]) for n, p in
               model.named_parameters())
    stripped = jparams.strip_serving_params(baked)
    assert jax.tree.structure(stripped) == jax.tree.structure(params)


_PROBE = r"""
import dataclasses, os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path[:0] = [{src!r}]
from repro.configs.registry import get_smoke_config as jget
from repro.launch import dryrun as jdry, mesh as jmesh
from repro_torch.configs.registry import get_smoke_config as tget
from repro_torch.launch import dryrun as tdry, mesh as tmesh
tdry.start_fake_group(8)
tm = tmesh.make_mesh((2, 4), ("data", "model"), device="cpu")
jm = jmesh.make_mesh((2, 4), ("data", "model"))
from repro.roofline.analysis import collective_bytes
out = {{}}
for name, arch, shape, fuse in (
        ("mixtral-8x7b", "mixtral-8x7b", "train_4k", False),
        ("tinyllama-1.1b", "tinyllama-1.1b", "decode_32k", False),
        ("tinyllama-1.1b/fuse", "tinyllama-1.1b", "decode_32k", True),
        ("tinyllama-1.1b/prefill", "tinyllama-1.1b", "prefill_32k", False)):
    jc, tc = (get(arch).replace(remat="none") for get in (jget, tget))
    if fuse:
        jc, tc = (c.replace(compression=dataclasses.replace(
            c.compression, fuse_projections=True)) for c in (jc, tc))
    _, compiled, _ = jdry.lower_cell(arch, shape, jm, cfg_override=jc,
                                     accum=1)
    rec, _ = tdry.lower_cell(arch, shape, tm, cfg_override=tc, accum=1)
    mem = compiled.memory_analysis()
    out[name] = {{"repro": int(mem.argument_size_in_bytes),
                 "port": rec.argument_bytes,
                 "repro_temp": int(mem.temp_size_in_bytes),
                 "port_temp": rec.temp_bytes,
                 "collectives": rec.collectives,
                 "repro_collectives": collective_bytes(compiled.as_text())}}
print("RESULT", json.dumps(out))
"""


@pytest.fixture(scope="module")
def small_mesh_cells():
    p = subprocess.run(
        [sys.executable, "-c", _PROBE.format(src=str(ROOT / "src"))],
        capture_output=True, text=True, timeout=600,
        env={k: v for k, v in os.environ.items() if k != "XLA_FLAGS"})
    line = [ln for ln in p.stdout.splitlines() if ln.startswith("RESULT ")]
    assert line, p.stdout[-2000:] + p.stderr[-4000:]
    return json.loads(line[-1][len("RESULT "):])


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "tinyllama-1.1b",
                                  "tinyllama-1.1b/fuse"])
def test_argument_bytes_match_repro_on_small_mesh(small_mesh_cells, arch):
    """mixtral's smoke train cell (expert-parallel stacks, int8 moments,
    the int32 step) and tinyllama's smoke decode cell, with and without
    projection fusion (baked planes, the read planes only, the fused
    caches sharded by the rules, the cache, the position): per-device
    argument bytes equal to XLA's ``memory_analysis()``."""
    cell = small_mesh_cells[arch]
    assert cell["port"] == cell["repro"] > 0


def test_decode_collectives_equal_hand_count(small_mesh_cells):
    """tinyllama's smoke decode step under Megatron on (data 2, model 4):
    d = 128, d_ff = 256, 2 layers, 4 heads of 32 (4 KV heads), k = 16
    (kf = 9), vocab 512, bf16 activations, float32 weights, B = 128 (64 a
    data shard), Gauss planes (wr, ws1, ws2 read).

    All-gathers (result bytes a device): each plane's data-axis shard
    gathered at its use (the rules put "model" on a column projection's p
    and a row projection's q, and the data axis on p; the gather gives the
    model shard): q, k, v (8, 8, 9) -> (2, 8, 9); o (8, 8, 9) -> (8, 2, 9);
    up, gate (16, 8, 9) -> (4, 8, 9); down (8, 16, 9) -> (8, 4, 9); the
    table (512, 128), vocab over both axes, gathered over data to its model
    shard (128, 128) twice (the embedding, the head); the last logits
    (64, 128) of a model rank gathered for the argmax (64, 512) bf16.

    All-reduces: the vocab-parallel embedding's rows (64, 1, 128) float32
    once, the row-parallel o and down outputs (64, 1, 128) bf16 a layer."""
    f32, bf16, kf, L = 4, 2, 9, 2
    planes = 3 * (3 * 2 * 8 + 8 * 2 + 2 * 4 * 8 + 8 * 4) * kf * f32 * L
    table = 2 * 128 * 128 * f32
    argmax = 64 * 512 * bf16
    want = {"all-gather": planes + table + argmax,
            "all-reduce": 64 * 128 * f32 + 2 * L * 64 * 128 * bf16,
            "reduce-scatter": 0, "all-to-all": 0, "collective-permute": 0,
            "collective-broadcast": 0}
    want["total"] = want["all-gather"] + want["all-reduce"]
    assert small_mesh_cells["tinyllama-1.1b"]["collectives"] == want


# tinyllama's smoke decode step: the fused q/k/v and up/gate outputs
# gathered over the model axis before the split, a data shard's 64 rows of
# 3 x 128 + 2 x 256 bfloat16 columns, 2 layers
FUSED_ACTIVATION_GATHER = 64 * (3 * 128 + 2 * 256) * 2 * 2


def test_fused_decode_moves_activations_not_weights(small_mesh_cells):
    """Projection fusion on the (2, 4) decode cell: the fused caches run
    on each rank's own output blocks (the rules shard their sum(p_i) dim
    over "model"), so the step's collectives are the unfused step's plus
    one all-gather of the fused outputs, and no weight more."""
    base = small_mesh_cells["tinyllama-1.1b"]["collectives"]
    fuse = small_mesh_cells["tinyllama-1.1b/fuse"]["collectives"]
    want = dict(base)
    want["all-gather"] += FUSED_ACTIVATION_GATHER
    want["total"] += FUSED_ACTIVATION_GATHER
    assert fuse == want


@pytest.mark.parametrize("cell", ["tinyllama-1.1b", "tinyllama-1.1b/fuse"])
def test_decode_collectives_near_xla(small_mesh_cells, cell):
    """The port's collective bytes a device against XLA's partition of
    ``repro``'s same cell (``collective_bytes`` of the compiled HLO): XLA
    chooses its own moves (it gathers the fused outputs by collective
    permutes, and all-reduces where the port gathers), so the totals are
    held within a factor of 2 of each other, not equal."""
    got = small_mesh_cells[cell]["collectives"]["total"]
    xla = small_mesh_cells[cell]["repro_collectives"]["total"]
    assert 0.5 * xla <= got <= 2 * xla, (got, xla)


def test_prefill_temp_beside_xla(small_mesh_cells, capsys):
    """A finding, not a bound: tinyllama's smoke prefill cell (bf16) on
    the (2, 4) mesh, the port's temp bytes a device (the trace of the
    card's path: the flash kernel's O(S) output) beside XLA's
    ``memory_analysis()`` of ``repro``'s (its chunked attention), printed
    with ``-s``."""
    cell = small_mesh_cells["tinyllama-1.1b/prefill"]
    with capsys.disabled():
        print(f"\nsmoke prefill_32k temp bytes a device on (2, 4): port "
              f"{cell['port_temp']:,}, XLA {cell['repro_temp']:,}")
    assert cell["port"] == cell["repro"] > 0
    assert cell["port_temp"] > 0 and cell["repro_temp"] > 0


# ---------------------------------------------------------------------------
# The kernels' stand-in (kernels/standin.py): each wrapper's card branch on
# fake tensors, its launch counted and charged with its module's work
# ---------------------------------------------------------------------------
from repro_torch.core import circulant as tcc  # noqa: E402
from repro_torch.kernels import bc_fused as tbf  # noqa: E402
from repro_torch.kernels import bc_grad_w as tgw  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import paged as tpg  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.kernels import spectral_matmul as tsm  # noqa: E402
from repro_torch.kernels import standin as tstandin  # noqa: E402
from repro_torch.quant import codec as tcodec  # noqa: E402


def _randn(rng, *shape, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dtype)


def _fused_case(lane, k=16, E=0, B=5, p=4, q=3):
    """(call, tensors, work, kernel, lane, path, shape, block) of one
    ``bc_fused`` launch: ``lane`` picks the MAC (Gauss or 4-product) and
    the planes (float32, int8, int4); E > 0 an expert stack."""
    rng = np.random.default_rng(k + E + len(lane))
    gauss = lane in tbf.LANES.values()
    lead = (E,) if E else ()
    w = _randn(rng, *lead, p, q, k)
    planes = tcc.spectral_cache(w, gauss)
    names = ("wr", "ws1", "ws2") if gauss else ("wr", "wi")
    scales = None
    if lane.endswith(("_i8", "_i4")):
        planes = tcodec.quantize_plane_cache(
            planes, 8 if lane.endswith("_i8") else 4)
        scales = [planes[n + "_s"] for n in names]
    xb = _randn(rng, *lead, B, q, k)
    fn = tbf.bc_fused_matmul if gauss else tbf.bc_fused4_matmul
    n = len(names)

    def call(x, *ts):
        return fn(x, *ts[:n], k, list(ts[n:]) or None)
    tensors = [xb, *(planes[m] for m in names), *(scales or [])]
    return (call, tensors, tbf.work(E or 1, B, p, q, k, lane), tbf.KERNEL,
            lane, "experts" if E else "single",
            tbf.shape_key(E or 1, B, p, q, k, lane), k)


def _grad_case(k=16, E=0, N=40, p=4, q=3):
    rng = np.random.default_rng(100 + k + E)
    lead = (E,) if E else ()
    gy, xb = _randn(rng, *lead, N, p, k), _randn(rng, *lead, N, q, k)
    return (lambda g, x: tgw.bc_grad_w(g, x, k), [gy, xb],
            tgw.work(N, p, q, k, E or 1), tgw.KERNEL, "bc_grad_w",
            "experts" if E else "single", tgw.shape_key(N, p, q, k, E or 1),
            k)


def _flash_case(B, Hq, Hkv, Sq, Skv, D, dtype, kv_dtype=None, **kw):
    rng = np.random.default_rng(Sq * 7 + Skv + D)
    q = _randn(rng, B, Hq, Sq, D).to(dtype)
    k, v = (_randn(rng, B, Hkv, Skv, D) for _ in range(2))
    from repro_torch.layers.attention import to_cache
    k, v = (to_cache(t, kv_dtype or dtype) for t in (k, v))
    pl = tfa.plan(B, Hq, Hkv, Sq, Skv, D, dtype, kv_dtype or dtype)
    e4m3 = kv_dtype == torch.float8_e4m3fn
    return (lambda a, b, c: tfa.flash_attention(a, b, c, **kw), [q, k, v],
            tfa.work(B, Hq, Hkv, Sq, Skv, D, dtype, kv_dtype, causal=kw.get(
                "causal", True), window=kw.get("window", 0),
                kv_offset=kw.get("kv_offset", 0)),
            tfa.KERNEL, "flash_attention",
            pl.path + ("_e4m3" if e4m3 else ""),
            tfa.shape_key(B, Hq, Hkv, Sq, Skv, D, dtype,
                          causal=kw.get("causal", True),
                          window=kw.get("window", 0),
                          kv_offset=kw.get("kv_offset", 0),
                          kv_dtype=kv_dtype), None)


def _paged_case(dtype, pool_dtype):
    rng = np.random.default_rng(7)
    B, Hq, Hkv, D, page, maxp = 3, 4, 2, 32, 4, 5
    P = B * maxp + 1
    q = _randn(rng, B, Hq, D).to(dtype)
    pk, pv = (_randn(rng, P, page, Hkv, D) for _ in range(2))
    table = torch.from_numpy(rng.permutation(P - 1)[:B * maxp].reshape(
        B, maxp).astype(np.int32) + 1)
    positions = torch.tensor([13, -1, 19], dtype=torch.int32)
    extra = []
    if pool_dtype == torch.int8:
        (pk, ks), (pv, vs) = (tcodec.quantize_page_block(t) for t in (pk, pv))
        extra = [ks, vs]
    else:
        pk, pv = pk.to(pool_dtype), pv.to(pool_dtype)

    def call(a, b, c, t, pos, *sc):
        kw = dict(zip(("k_scale", "v_scale"), sc))
        return tpa.paged_attention(a, b, c, t, pos, **kw)
    lane = "paged_attention_i8" if extra else "paged_attention"
    # a trace has no positions: the stand-in counts every slot at its
    # table's end
    return (call, [q, pk, pv, table, positions, *extra],
            tpa.work(B, Hq, Hkv, D, page, maxp, [maxp * page - 1] * B,
                     dtype, pool_dtype),
            tpa.KERNEL, lane, None, None, None)


def _gather_case(dtype):
    rng = np.random.default_rng(9)
    P, page, H, D, B, maxp = 11, 4, 2, 8, 2, 5
    pool = (_randn(rng, P, page, H, D) * 40).clamp(-127, 127).to(dtype)
    table = torch.from_numpy(rng.integers(0, P, (B, maxp)).astype(np.int32))
    return (tpg.paged_gather, [pool, table],
            tpg.work(B, maxp, page * H * D * pool.element_size()),
            tpg.KERNEL, "paged_gather", None, None, None)


def _spectral_case(layout):
    rng = np.random.default_rng(11 + layout)
    F, N, Q, P = 9, 20, 3, 5
    if layout == tsm.BIN_MAJOR:
        xs = [_randn(rng, F, N, Q) for _ in range(2)]
        ws = [_randn(rng, F, Q, P) for _ in range(3)]
        call = tsm.spectral_matmul
    else:                  # the hook's views of (N, Q, F) and (P, Q, F)
        xs = [_randn(rng, N, Q, F) for _ in range(2)]
        ws = [_randn(rng, P, Q, F) for _ in range(3)]

        def call(xr, xi, wr, ws1, ws2):
            return tsm.spectral_matmul(
                *(t.permute(2, 0, 1) for t in (xr, xi)),
                *(t.permute(2, 1, 0) for t in (wr, ws1, ws2)))
    return (call, [*xs, *ws], tsm.work(F, N, Q, P), tsm.KERNEL,
            "spectral_matmul", None, tsm.shape_key(F, N, Q, P, layout), None)


f32, bf16, e4m3 = torch.float32, torch.bfloat16, torch.float8_e4m3fn
STANDIN_CASES = {
    "bc_fused": lambda: _fused_case("bc_fused"),
    "bc_fused_i8": lambda: _fused_case("bc_fused_i8"),
    "bc_fused_i4": lambda: _fused_case("bc_fused_i4"),
    "bc_fused4": lambda: _fused_case("bc_fused4"),
    "bc_fused4_i8": lambda: _fused_case("bc_fused4_i8"),
    "bc_fused4_i4": lambda: _fused_case("bc_fused4_i4"),
    "bc_fused_k12": lambda: _fused_case("bc_fused", k=12),
    "bc_fused_k4": lambda: _fused_case("bc_fused", k=4),
    "bc_fused_k256": lambda: _fused_case("bc_fused", k=256, q=1, p=2),
    "bc_fused_experts": lambda: _fused_case("bc_fused", E=3),
    "bc_fused4_i8_experts": lambda: _fused_case("bc_fused4_i8", E=2),
    "bc_grad_w": lambda: _grad_case(),
    "bc_grad_w_k12": lambda: _grad_case(k=12),
    "bc_grad_w_experts": lambda: _grad_case(E=2),
    "flash_bf16": lambda: _flash_case(1, 4, 2, 20, 20, 64, bf16),
    "flash_f32_rows": lambda: _flash_case(1, 4, 2, 20, 20, 32, f32),
    "flash_f32_mma": lambda: _flash_case(1, 4, 2, 24, 24, 64, f32),
    "flash_split_decode": lambda: _flash_case(
        1, 2, 1, 1, 300, 32, f32, kv_offset=299),
    "flash_e4m3_decode": lambda: _flash_case(
        2, 4, 2, 1, 70, 32, f32, e4m3, kv_offset=69),
    "flash_window_softcap": lambda: _flash_case(
        1, 2, 2, 40, 40, 32, f32, window=8, softcap=5.0),
    "paged_f32": lambda: _paged_case(bf16, f32),
    "paged_bf16": lambda: _paged_case(bf16, bf16),
    "paged_i8": lambda: _paged_case(f32, torch.int8),
    "gather_f32": lambda: _gather_case(f32),
    "gather_i8": lambda: _gather_case(torch.int8),
    "spectral_bin_major": lambda: _spectral_case(tsm.BIN_MAJOR),
    "spectral_bin_minor": lambda: _spectral_case(tsm.BIN_MINOR),
}


def _outs(o):
    return list(o) if isinstance(o, (tuple, list)) else [o]


@pytest.mark.parametrize("case", sorted(STANDIN_CASES))
def test_standin_matches_plain_and_charges_work(case):
    """One launch of each wrapper's card branch on fake copies of the
    inputs, inside ``standin``: its outputs' shapes, dtypes and strides
    equal the plain version's on the real inputs; ``StepCost`` is charged
    the module's ``work`` (FLOPs and bytes, nothing twice), its peak is
    the outputs plus the work's scratch (the DFT panels built first, as a
    warm card has them); one launch is counted at the card's lane, path
    and shape, and the kernels' counts are as they were after the
    block."""
    call, tensors, want, kernel, lane, path, shape, k = STANDIN_CASES[case]()
    plain = _outs(call(*tensors))
    before = (kernel.launches, dict(kernel.fn_launches))
    mode = treg.fake_mode()
    fakes = [mode.from_tensor(t) for t in tensors]
    with mode:
        if k is not None:                 # the constants a warm card holds
            tbf.dft_panel(k, "cpu"), tbf.dft_panel_t(k, "cpu")
            tgw.packed_panel_t(k, "cpu")
            if tgw.folded(k):
                tgw.dft_panel(k, "cpu")
        with troof.StepCost() as cost, tstandin.standin(cost):
            got = _outs(call(*fakes))
            counts = tstandin.launch_counts()
            peak = cost.peak
    assert [(tuple(t.shape), t.dtype, t.stride()) for t in got] == \
        [(tuple(t.shape), t.dtype, t.stride()) for t in plain]
    assert cost.flops == want.flops and cost.bytes_accessed == want.nbytes
    out_bytes = sum({id(t.untyped_storage()): t.untyped_storage().nbytes()
                     for t in got}.values())
    assert peak == out_bytes + want.scratch
    assert counts == {kernel.name: {
        "lanes": {lane: 1}, "paths": {path: 1} if path else {},
        "shapes": {shape: 1} if shape else {}}}
    assert (kernel.launches, dict(kernel.fn_launches)) == before


def test_standin_leaves_real_tensors_plain():
    """Inside the block a real CPU tensor still takes the plain version
    (and counts no launch); outside it a fake one does too."""
    call, tensors, *_ = STANDIN_CASES["bc_fused"]()
    want = call(*tensors)
    with tstandin.standin():
        got = call(*tensors)
        assert tstandin.launch_counts() == {}
    assert torch.equal(got, want)
    mode = treg.fake_mode()
    with mode:
        out = call(*(mode.from_tensor(t) for t in tensors))
    assert out.shape == want.shape


def test_standin_restores_the_seams():
    """The seams and ``Kernel.launch`` are the module's own after the
    block, also when the body raises."""
    from repro_torch.kernels import build as tbuild
    seams = {m: {n: getattr(m, n) for n in ("on_cpu", "on_card", "address",
                                            "ptr") if n in vars(m)}
             for m in (tbuild, *tstandin.MODULES)}
    launch = tbuild.Kernel.launch
    with pytest.raises(RuntimeError):
        with tstandin.standin():
            assert tbuild.Kernel.launch is not launch
            raise RuntimeError("body")
    assert tbuild.Kernel.launch is launch
    assert seams == {m: {n: getattr(m, n) for n in s} for m, s in
                     seams.items()}


# ---------------------------------------------------------------------------
# The cells on a one-rank mesh: the card's path, its lanes, its launches
# ---------------------------------------------------------------------------
_ONE_PROBE = r"""
import sys, json, dataclasses
sys.path[:0] = [{src!r}]
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch import dryrun, mesh as mesh_lib
dryrun.start_fake_group(1)
mesh = mesh_lib.make_mesh((1, 1), ("data", "model"), device="cpu")
cfg = get_smoke_config("tinyllama-1.1b").replace(dtype="float32")
out = {{}}
for name, shape, batch, accum in (("decode", "decode_32k", 2, 4),
                                  ("prefill", "prefill_32k", 2, 4),
                                  ("train", "train_4k", 4, 4)):
    rec, meta = dryrun.lower_cell("tinyllama-1.1b", shape, mesh,
                                  cfg_override=cfg, global_batch=batch,
                                  accum=accum)
    out[name] = {{"launches": rec.launches, "temp": rec.temp_bytes,
                 "lanes": meta.get("prefill_lanes")}}
full = dryrun.SHAPES_BY_NAME["prefill_32k"]
dryrun.SHAPES_BY_NAME["prefill_32k"] = dataclasses.replace(
    full, seq_len=full.seq_len // 2)
rec, _ = dryrun.lower_cell("tinyllama-1.1b", "prefill_32k", mesh,
                           cfg_override=cfg, global_batch=2)
out["prefill_half"] = {{"temp": rec.temp_bytes}}
dryrun.SHAPES_BY_NAME["prefill_32k"] = full
rec, _ = dryrun.lower_cell("tinyllama-1.1b", "decode_32k", mesh,
                           cfg_override=get_smoke_config("tinyllama-1.1b"),
                           global_batch=2)
out["bf16_decode"] = {{"launches": rec.launches}}
print("RESULT", json.dumps(out))
"""


@pytest.fixture(scope="module")
def one_rank_cells():
    p = subprocess.run(
        [sys.executable, "-c", _ONE_PROBE.format(src=str(ROOT / "src"))],
        capture_output=True, text=True, timeout=600)
    line = [ln for ln in p.stdout.splitlines() if ln.startswith("RESULT ")]
    assert line, p.stdout[-2000:] + p.stderr[-4000:]
    return json.loads(line[-1][len("RESULT "):])


def _blocks(cfg):
    """(p, q) of each of a layer's seven projections: q, k, v, o, up,
    gate, down."""
    a, k = cfg.attention, cfg.compression.block_attn
    d, dff = cfg.d_model, cfg.d_ff
    hq, hkv = a.num_heads * a.head_dim, a.num_kv_heads * a.head_dim
    return [(tcc.num_blocks(n_out, k), tcc.num_blocks(n_in, k))
            for n_in, n_out in ((d, hq), (d, hkv), (d, hkv), (hq, d),
                                (d, dff), (d, dff), (dff, d))]


def _count(pairs):
    out = {}
    for key, n in pairs:
        out[key] = out.get(key, 0) + n
    return out


def test_one_rank_launches_equal_hand_count(one_rank_cells):
    """tinyllama's smoke config in float32 (2 layers, d = 128, 4 heads of
    32, d_ff = 256, block 16, no remat) on a one-rank mesh: the launches
    a device makes by lane, path and shape, counted from the model.
    Decode (2 rows at position 32,767): each projection one ``bc_fused``
    launch, each layer one flash launch on the float32 rows kernel.
    Prefill (2 x 32,768): each projection's MAC one ``spectral_matmul``
    launch over its kf = 9 bins, each layer one flash launch.  Train (4
    rows, 4 microbatches of 4,096): each projection's forward and adjoint
    (p and q swapped) on ``bc_fused`` and its weight gradient on
    ``bc_grad_w``, each microbatch."""
    cfg = get_smoke_config("tinyllama-1.1b").replace(dtype="float32")
    L, k = cfg.num_layers, cfg.compression.block_attn
    a = cfg.attention
    Hq, Hkv, D, kf, S = a.num_heads, a.num_kv_heads, a.head_dim, k // 2 + 1, \
        32768
    blocks = _blocks(cfg)
    flash = lambda B, Sq, off: {"flash_attention": {  # noqa: E731
        "lanes": {"flash_attention": L}, "paths": {"f32_rows": L},
        "shapes": {tfa.shape_key(B, Hq, Hkv, Sq, S, D, torch.float32,
                                 causal=True, kv_offset=off): L}}}
    fused = lambda rows, pairs, n: {  # noqa: E731
        "lanes": {"bc_fused": n * L * len(pairs)},
        "paths": {"single": n * L * len(pairs)},
        "shapes": _count((tbf.shape_key(1, rows, p, q, k, "bc_fused"),
                          n * L) for p, q in pairs)}
    want = {"bc_fused": fused(2, blocks, 1), **flash(2, 1, S - 1)}
    assert one_rank_cells["decode"]["launches"] == want
    want = {"spectral_matmul": {
        "lanes": {"spectral_matmul": L * len(blocks)}, "paths": {},
        "shapes": _count((tsm.shape_key(kf, 2 * S, q, p, tsm.BIN_MINOR), L)
                         for p, q in blocks)}, **flash(2, S, 0)}
    assert one_rank_cells["prefill"]["launches"] == want
    n = 4                                       # microbatches
    f = fused(4096, blocks + [(q, p) for p, q in blocks], n)
    want = {"bc_fused": f, "bc_grad_w": {
        "lanes": {"bc_grad_w": n * L * len(blocks)},
        "paths": {"single": n * L * len(blocks)},
        "shapes": _count((tgw.shape_key(4096, p, q, k), n * L)
                         for p, q in blocks)}}
    assert one_rank_cells["train"]["launches"] == want


def test_prefill_cell_takes_the_contracts_lanes(one_rank_cells):
    """The prefill cell traces the batch engine's prefill with its
    ``PrefillContract``: the plane shapes the record lists under each lane
    are the contract's own choice for the smoke model's baked caches (an
    engine's contract, built on real planes), and each ``spectral_matmul``
    launch is at one of the shapes it took."""
    from repro_torch.serve.engine import PrefillContract
    from repro_torch.serve.params import precompute_serving_params
    cfg = get_smoke_config("tinyllama-1.1b").replace(dtype="float32")
    params = precompute_serving_params(
        treg.init_params(cfg, seed=0, device="cpu"), cfg)
    want = PrefillContract(params).report()
    assert one_rank_cells["prefill"]["lanes"] == want
    took = {tuple(map(int, s.split("x"))) for s in want["spectral_matmul"]}
    for key in one_rank_cells["prefill"]["launches"]["spectral_matmul"][
            "shapes"]:
        F, N, Q, P = map(int, key.split("/")[0].split("x"))
        assert (P, Q, F) in took


def test_prefill_temp_grows_with_s_not_s_squared(one_rank_cells):
    """Doubling S in the smoke prefill cell (16,384 -> 32,768 positions, 2
    rows) at most about doubles its temp bytes: the flash kernel keeps
    O(S) where the plain attention's scores grew as S^2."""
    half = one_rank_cells["prefill_half"]["temp"]
    full = one_rank_cells["prefill"]["temp"]
    assert half > 0 and full <= 2.05 * half, (half, full)


def test_bf16_smoke_decode_fails_as_the_card_would(one_rank_cells):
    """The smoke config in its own dtype (bf16 activations and cache, head
    dim 32) traces its decode on the card's path: each layer one flash
    launch on the bf16 tensor-core kernel at D = 32 (its 32 tile), the
    projections as in the float32 cell."""
    cfg = get_smoke_config("tinyllama-1.1b")
    assert cfg.dtype == "bfloat16" and cfg.attention.head_dim == 32
    L, a, S = cfg.num_layers, cfg.attention, 32768
    assert tfa.plan(2, a.num_heads, a.num_kv_heads, 1, S, a.head_dim,
                    torch.bfloat16).tile == 32
    got = one_rank_cells["bf16_decode"]["launches"]
    assert got["flash_attention"] == {
        "lanes": {"flash_attention": L}, "paths": {"bf16": L},
        "shapes": {tfa.shape_key(2, a.num_heads, a.num_kv_heads, 1, S,
                                 a.head_dim, torch.bfloat16, causal=True,
                                 kv_offset=S - 1): L}}
    f32 = one_rank_cells["decode"]["launches"]
    assert got.keys() == f32.keys()
    assert got["bc_fused"]["lanes"] == f32["bc_fused"]["lanes"]
