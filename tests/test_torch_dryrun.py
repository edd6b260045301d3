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
        ("tinyllama-1.1b/fuse", "tinyllama-1.1b", "decode_32k", True)):
    jc, tc = (get(arch).replace(remat="none") for get in (jget, tget))
    if fuse:
        jc, tc = (c.replace(compression=dataclasses.replace(
            c.compression, fuse_projections=True)) for c in (jc, tc))
    _, compiled, _ = jdry.lower_cell(arch, shape, jm, cfg_override=jc,
                                     accum=1)
    rec, _ = tdry.lower_cell(arch, shape, tm, cfg_override=tc, accum=1)
    out[name] = {{"repro": int(compiled.memory_analysis()
                              .argument_size_in_bytes),
                 "port": rec.argument_bytes,
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
