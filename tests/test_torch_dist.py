"""``repro_torch.dist``, ``launch/mesh.py`` and the int8 wire all-reduce
against ``repro``, on the CPU; then the two repairs of the decoder-only
``Transformer`` (untied heads, learned positions).

* ``param_specs`` equals ``repro``'s on all ten archs' smoke trees over
  ``repro``'s own fake-mesh list (``tests/test_sharding_properties.py``'s
  ``MESHES``), with float32 planes baked and, on three archs, int8 planes
  with their scales: a port leaf's spec is ``repro``'s spec of the
  stacked leaf it was carried from (``models/convert.py``'s names) without
  its leading stack dim.  The cache, pool, batch, head and logits specs
  equal ``repro``'s on the same shapes; ``to_placements`` and
  ``local_shape`` on a (16, 16) mesh.
* The activation policy: identity outside a policy, for a plain tensor
  and for a rank other than 3; a ``DTensor`` on a one-rank gloo mesh is
  redistributed to the pinned placement (batch over "data").
* ``wire_allreduce_int8`` on one rank is the int8 round trip, and on two
  gloo ranks (``torch.multiprocessing.spawn``) the formula ``sum_r q_r *
  max_r s_r / 2`` in numpy, exactly; ``make_production_mesh`` refuses
  below 256 ranks.
* ``tie_embeddings=False``: the port raised; it now computes ``repro``'s
  logits (``repro`` has no untied head: it builds only ``embed``).
  ``max_position > 0``: ``repro``'s decoder-only forward adds the learned
  table (``src/repro/models/transformer.py:241-246``); the port carries
  ``pos`` and adds it too.  Logits within 1e-4 of their scale, prefill and
  a decode step.
"""
import functools
import os
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.configs.registry import ARCH_IDS  # noqa: E402
from repro.configs.registry import get_smoke_config as jget  # noqa: E402
from repro.dist import sharding as jsh  # noqa: E402
from repro.models.registry import build_model  # noqa: E402
from repro.quant.codec import QuantPolicy as JQuant  # noqa: E402
from repro.serve.params import precompute_serving_params as jbake  # noqa: E402
from repro_torch.configs.registry import get_smoke_config as tget  # noqa: E402
from repro_torch.dist import ctx as tctx  # noqa: E402
from repro_torch.dist import sharding as tsh  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.optim import grad_compression as tgc  # noqa: E402


class FakeMesh:                       # tests/test_sharding_properties.py
    def __init__(self, shape, names):
        self.devices = np.zeros(shape)
        self.axis_names = names


MESHES = [
    FakeMesh((16, 16), ("data", "model")),
    FakeMesh((2, 16, 16), ("pod", "data", "model")),
    FakeMesh((2, 4), ("data", "model")),
    FakeMesh((3, 5), ("data", "model")),
    FakeMesh((4, 2, 8), ("pod", "data", "model")),
    FakeMesh((1, 1), ("data", "model")),
]
QUANTIZED = ("tinyllama-1.1b", "llama4-maverick-400b-a17b", "gemma2-9b")


def _key(k):
    return str(getattr(k, "key", getattr(k, "idx", k)))


@functools.lru_cache(maxsize=None)
def _trees(arch):
    """``repro``'s smoke tree with baked planes (int8 on ``QUANTIZED``) as
    numpy zeros (shapes from ``jax.eval_shape``), and the port's model
    carried from it."""
    cfg = jget(arch)
    bits = 8 if arch in QUANTIZED else 0
    shapes = jax.eval_shape(lambda: jbake(
        build_model(cfg).init(jax.random.PRNGKey(0)), cfg,
        JQuant(weight_bits=bits) if bits else None))
    tree = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    return cfg, tree, from_jax_params(tree, tget(arch), device="cpu")


def _port_names(cfg, path):
    """The port's module names of a ``repro`` leaf path, and whether the
    leaf is stacked (its leading dim one layer each)."""
    def join(prefix, rest):
        rest = ["self_attn" if r == "self" else r for r in rest]
        if len(rest) >= 2 and rest[-2].endswith("_cache"):
            rest = rest[:-2] + [f"{rest[-2]}_{rest[-1]}"]
        return ".".join([prefix] + rest)
    if path[0] == "segments":
        si, bi, rest = int(path[1]), int(path[2]), list(path[3:])
        segs = ttf.segments_for(cfg)
        base = sum(len(p) * n for p, n in segs[:si])
        width, n = len(segs[si][0]), segs[si][1]
        return [join(f"blocks.{base + g * width + bi}", rest)
                for g in range(n)], True
    if path[0] in ("enc_blocks", "dec_blocks"):
        layers = cfg.encoder_layers if path[0] == "enc_blocks" \
            else cfg.num_layers
        return [join(f"{path[0]}.{i}", list(path[1:]))
                for i in range(layers)], True
    return [join(path[0], list(path[1:]))], False


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_repro(arch):
    cfg, tree, model = _trees(arch)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    for mesh in MESHES:
        want = jsh.param_specs(tree, mesh)
        wflat = jax.tree_util.tree_flatten_with_path(
            want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
        )[0]
        got = tsh.param_specs(model, mesh)
        seen = set()
        for (path, _), (_, spec) in zip(flat, wflat):
            names, stacked = _port_names(cfg, tuple(map(_key, path)))
            ref = tuple(spec)[1:] if stacked else tuple(spec)
            for name in names:
                assert got[name] == ref, (arch, mesh.devices.shape, name,
                                          got[name], ref)
                seen.add(name)
        assert seen == set(got), sorted(set(got) - seen)[:5]


@pytest.mark.parametrize("mesh", MESHES, ids=[str(m.devices.shape)
                                              for m in MESHES])
def test_activation_and_cache_specs_match_repro(mesh):
    for shape in [(8, 128, 4096), (256, 1, 4096), (12, 7, 64), (1, 3, 5)]:
        for gb in (shape[0], 2 * shape[0]):
            for seq in (False, True):
                assert tsh.batch_spec(shape, mesh, gb, seq) == tuple(
                    jsh.batch_spec(shape, mesh, gb, seq))
    for shape in [(22, 256, 4096, 4, 64), (32, 8, 512, 32, 128),
                  (8, 512, 8, 128), (6, 9, 2, 16)]:
        for dt in (np.float32, np.int32):
            assert tsh.cache_spec((), shape, dt, mesh, shape[-4]) == tuple(
                jsh.cache_spec((), shape, dt, mesh, shape[-4]))
        assert tsh.page_pool_spec(shape, mesh) == tuple(
            jsh.page_pool_spec(shape, mesh))
        assert tsh.page_scale_spec(shape[:-1], mesh) == tuple(
            jsh.page_scale_spec(shape[:-1], mesh))
    for shape in [(256, 32, 64), (8, 40, 128), (3, 5, 7)]:
        assert tsh.decode_head_spec(shape, mesh) == tuple(
            jsh.decode_head_spec(shape, mesh))
    for gb, vocab in [(256, 32000), (8, 50304), (3, 7)]:
        assert tsh.logits_spec(mesh, gb, vocab) == tuple(
            jsh.logits_spec(mesh, gb, vocab))
    assert tsh.dp_round_up(129, mesh) == jsh.dp_round_up(129, mesh)


def test_pool_and_cache_specs_match_repro():
    """The tree-mapped forms over the port's int8 pool and dense cache
    (float and integer leaves, the scales) against ``repro``'s over its
    own, on a 256- and a 512-rank mesh: ``repro``'s segment-stacked dense
    cache of tinyllama's smoke config and the port's stacked one share
    their shapes."""
    from repro.quant.codec import QuantPolicy as JQ
    from repro.serve import kvcache as jkv
    from repro_torch.quant.codec import QuantPolicy as TQ
    from repro_torch.serve import kvcache as tkv
    cfg, tcfg = jget("tinyllama-1.1b"), tget("tinyllama-1.1b")
    jpool = jax.eval_shape(lambda: jkv.build_pool(cfg, 33, 16, JQ("int8")))
    tpool = tkv.build_pool(tcfg, 33, 16, TQ("int8"), device="cpu")
    jcache = jax.eval_shape(lambda: build_model(cfg).init_cache(
        16, 64, jnp.float32))
    tcache = ttf.init_cache(tcfg, 16, 64, device="cpu", dtype=torch.float32)
    for mesh in MESHES[:2]:
        want = {_key(p[-1]): tuple(sp) for p, sp in
                jax.tree_util.tree_flatten_with_path(
                    jsh.pool_specs(jpool, mesh), is_leaf=lambda x: isinstance(
                        x, jax.sharding.PartitionSpec))[0]}
        assert tsh.pool_specs(tpool, mesh) == want
        wc = jax.tree_util.tree_flatten_with_path(
            jsh.cache_specs(jcache, mesh, 16), is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))[0]
        assert tsh.cache_specs(tcache, mesh, 16) == {
            _key(p[-1]): tuple(sp) for p, sp in wc}


def test_placements_and_local_shape():
    from torch.distributed.tensor import Replicate, Shard

    class Duck:                        # a DeviceMesh's names, no devices
        mesh_dim_names = ("data", "model")
        shape = (16, 16)
    mesh = Duck()
    spec = tsh.param_spec(("blocks", "0", "mlp", "up", "wc"), (32, 16, 128),
                          mesh)
    assert spec == tsh.P("model", None, "data")
    assert tsh.to_placements(spec, mesh) == [Shard(2), Shard(0)]
    assert tsh.to_placements(tsh.P(), mesh) == [Replicate(), Replicate()]
    assert tsh.local_shape((44, 16, 128), tsh.P(None, None, ("data",
                                                             "model")),
                           mesh) == (44, 16, 0)
    assert tsh.local_shape((32, 16, 128), spec, mesh) == (2, 16, 8)
    assert tsh.module_path("blocks.3.moe.experts.up_cache_wr_s") == (
        "blocks", "3", "moe", "experts", "up_cache", "wr_s")


@pytest.fixture(scope="module")
def host_mesh():
    mesh = tmesh.make_host_mesh("cpu")
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (dist.get_world_size(), 1)
    assert tmesh.make_host_mesh("cpu") is mesh
    return mesh


def test_policy_identities(host_mesh):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    x = torch.randn(4, 6, 8)
    assert tctx.current_policy() is None
    assert tctx.shard_act(x) is x and tctx.shard_heads(x) is x
    with tctx.activation_policy(host_mesh, seq_shard=True):
        assert tctx.current_policy() == (host_mesh, True)
        assert tctx.shard_act(x) is x                  # a plain tensor
        assert tctx.shard_heads(x) is x
        y = torch.randn(4, 6)
        assert tctx.shard_act(y) is y                  # rank 2
        d = distribute_tensor(x, host_mesh, [Replicate(), Replicate()])
        pinned = tctx.shard_act(d)
        assert list(pinned.placements) == [Shard(0), Shard(1)]
        torch.testing.assert_close(pinned.full_tensor(), x, rtol=0, atol=0)
        with tctx.activation_policy(host_mesh):
            assert tctx.current_policy() == (host_mesh, False)
    assert tctx.current_policy() is None


def test_wire_allreduce_one_rank_is_the_round_trip(host_mesh):
    rng = np.random.RandomState(0)
    grads = {"a": torch.from_numpy(rng.randn(5, 7).astype(np.float32)),
             "b": [torch.from_numpy(rng.randn(3).astype(np.float32))]}
    got = tgc.wire_allreduce_int8(grads, host_mesh, axis="data")
    for g, w in ((got["a"], grads["a"]), (got["b"][0], grads["b"][0])):
        scale = max(float(w.abs().max()), 1e-12) / 127.0
        q = torch.clamp(torch.round(w / scale), -127, 127)
        torch.testing.assert_close(g, q * scale, rtol=0, atol=0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _wire_rank(rank, port, out):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    try:
        mesh = tmesh.make_mesh((2, 1), ("pod", "data"), device="cpu")
        g = torch.from_numpy(np.random.RandomState(rank).randn(6, 5).astype(
            np.float32) * (rank + 1))
        got = tgc.wire_allreduce_int8({"g": g}, mesh, axis="pod")["g"]
        np.save(os.path.join(out, f"rank{rank}.npy"), got.numpy())
    finally:
        dist.destroy_process_group()


def test_wire_allreduce_two_gloo_ranks(tmp_path):
    torch.multiprocessing.spawn(_wire_rank, args=(_free_port(),
                                                  str(tmp_path)),
                                nprocs=2, join=True)
    gs = [np.random.RandomState(r).randn(6, 5).astype(np.float32) * (r + 1)
          for r in range(2)]
    scales = [np.float32(max(np.abs(g).max(), 1e-12) / np.float32(127.0))
              for g in gs]
    qs = [np.clip(np.round(g / s), -127, 127).astype(np.int32)
          for g, s in zip(gs, scales)]
    want = (qs[0] + qs[1]).astype(np.float32) * max(scales) / np.float32(2)
    for r in range(2):
        np.testing.assert_array_equal(np.load(tmp_path / f"rank{r}.npy"),
                                      want)


def test_production_mesh_needs_its_ranks():
    for multi in (False, True):
        with pytest.raises(RuntimeError, match="ranks"):
            tmesh.make_production_mesh(multi_pod=multi, device="cpu")


# ---------------------------------------------------------------------------
# the repairs: untied heads, learned positions
# ---------------------------------------------------------------------------
REPAIRS = {"untied": dict(tie_embeddings=False),
           "learned_pos": dict(max_position=64)}


@pytest.mark.parametrize("case", sorted(REPAIRS))
def test_decoder_only_repairs_match_repro(case):
    """The port raised ``NotImplementedError`` on both configs; it now
    computes ``repro``'s logits: a 9-token prefill and, with learned
    positions (read at the cache position), one decode step over a
    float32 cache."""
    from repro.models import transformer as jtf
    kw = REPAIRS[case]
    cfg = jget("tinyllama-1.1b").replace(dtype="float32", **kw)
    tcfg = tget("tinyllama-1.1b").replace(dtype="float32", **kw)
    params = jax.jit(build_model(cfg).init)(jax.random.PRNGKey(1))
    assert ("pos" in params) == ("max_position" in kw)
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                            device="cpu")
    if "pos" in params:
        np.testing.assert_array_equal(model.pos.pos.numpy(),
                                      np.asarray(params["pos"]["pos"]))
    toks = np.random.RandomState(2).randint(1, 500, (2, 10))
    jcache = jtf.init_cache(cfg, 2, 12, jnp.float32)
    jl, _, jcache = jtf.forward(params, jnp.asarray(toks[:, :9]), cfg,
                                cache=jcache, cache_pos=0)
    tcache = ttf.init_cache(tcfg, 2, 12, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        tl, tcache = ttf.forward(model, torch.from_numpy(toks[:, :9]), tcfg,
                                 cache=tcache, cache_pos=0)
    pairs = [(tl, jl)]
    if "pos" in params:
        jl2, _, _ = jtf.forward(params, jnp.asarray(toks[:, 9:]), cfg,
                                cache=jcache, cache_pos=9)
        with torch.no_grad():
            tl2, _ = ttf.forward(model, torch.from_numpy(toks[:, 9:]),
                                 tcfg, cache=tcache, cache_pos=9)
        pairs.append((tl2, jl2))
    for got, want in pairs:
        want = np.asarray(want)
        tol = 1e-4 * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
