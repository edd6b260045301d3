"""The port stands alone and never falls back to the CPU.

* With ``jax`` blocked, every ``repro_torch`` module and ``chip_smoke``
  import, and none of them loads ``repro`` or any ``repro.*`` module.
* An entry point given no device runs on the CUDA card; on a machine
  without one it raises instead of continuing on the CPU.
* The kernel wrappers take the plain path only for CPU tensors: a tensor
  on any other device goes to the kernel's checks and is refused there.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.core import circulant as cc  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import (bc_fused, flash_attention, paged,  # noqa: E402
                                 paged_attention, spectral_matmul)
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.quant import codec  # noqa: E402
from repro_torch.serve.engine import ContinuousEngine, Engine  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None                 # any `import jax` now fails
sys.path[:0] = [{src!r}, {root!r}]
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
for name in ("repro_torch.quant", "repro_torch.quant.codec",
             "repro_torch.quant.calibrate", "repro_torch.kernels.paged",
             "repro_torch.kernels.spectral_matmul", "repro_torch.layers.ffn",
             "repro_torch.serve.decode", "repro_torch.serve.engine",
             "repro_torch.obs", "repro_torch.obs.__main__",
             "repro_torch.obs.chrometrace", "repro_torch.obs.emit",
             "repro_torch.obs.health", "repro_torch.obs.metrics",
             "repro_torch.obs.prof", "repro_torch.obs.slo",
             "repro_torch.obs.trace", "repro_torch.roofline",
             "repro_torch.roofline.analysis", "repro_torch.roofline.report",
             "repro_torch.serve.faults", "repro_torch.fleet",
             "repro_torch.fleet.replica", "repro_torch.fleet.router",
             "repro_torch.core.conv", "repro_torch.core.compression",
             "repro_torch.core.theory", "repro_torch.launch.serve",
             "repro_torch.launch.dryrun", "repro_torch.launch.hillclimb",
             "repro_torch.dist.spmd"):
    assert name in names, name
leaked = sorted(n for n in sys.modules if n == "repro" or n.startswith("repro."))
assert not leaked, leaked
print(len(names))
"""


def test_imports_without_jax_or_repro():
    code = _PROBE.format(src=str(ROOT / "src"), root=str(ROOT))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT), env=env)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25    # every module was walked


def test_no_device_means_the_card():
    cfg = get_smoke_config("tinyllama-1.1b")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg)
    cpu_model = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousEngine(cfg, cpu_model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cfg, cpu_model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.from_jax_params({}, cfg)
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "tinyllama-1.1b"])


def test_wrappers_refuse_non_cpu_tensors():
    """A tensor that is not on the CPU never takes the plain path."""
    meta = dict(device="meta")
    k = 16
    planes = cc.spectral_cache(torch.zeros((2, 3, k), **meta))
    with pytest.raises(ValueError, match="expected CUDA"):
        bc_fused.bc_fused_matmul(torch.zeros((4, 3, k), **meta),
                                 planes["wr"], planes["ws1"], planes["ws2"],
                                 k)
    q = torch.zeros((1, 2, 8, 16), **meta)
    with pytest.raises(ValueError, match="expected CUDA"):
        flash_attention.flash_attention(q, q, q)
    pool = torch.zeros((3, 4, 2, 16), **meta)
    table = torch.zeros((2, 2), dtype=torch.int32, **meta)
    pos = torch.zeros((2,), dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="expected CUDA"):
        paged_attention.paged_attention(torch.zeros((2, 4, 16), **meta),
                                        pool, pool, table, pos)
    # the quantized lanes and the gather
    qplanes = codec.quantize_plane_cache(planes)
    scales = [qplanes[n + "_s"] for n in ("wr", "ws1", "ws2")]
    with pytest.raises(ValueError, match="expected CUDA"):
        bc_fused.bc_fused_matmul(torch.zeros((4, 3, k), **meta),
                                 qplanes["wr"], qplanes["ws1"],
                                 qplanes["ws2"], k, scales)
    # the 4-product lanes (gauss_trick=False), float32 and quantized
    with pytest.raises(ValueError, match="expected CUDA"):
        bc_fused.bc_fused4_matmul(torch.zeros((4, 3, k), **meta),
                                  planes["wr"], planes["wi"], k)
    with pytest.raises(ValueError, match="expected CUDA"):
        bc_fused.bc_fused4_matmul(torch.zeros((4, 3, k), **meta),
                                  qplanes["wr"], qplanes["wi"], k,
                                  [qplanes["wr_s"], qplanes["wi_s"]])
    pool8 = torch.zeros((3, 4, 2, 16), dtype=torch.int8, **meta)
    sc = torch.zeros((3, 2), **meta)
    with pytest.raises(ValueError, match="expected CUDA"):
        paged_attention.paged_attention(torch.zeros((2, 4, 16), **meta),
                                        pool8, pool8, table, pos,
                                        k_scale=sc, v_scale=sc)
    for p in (pool, pool8):
        with pytest.raises(ValueError, match="expected CUDA"):
            paged.paged_gather(p, table)
    x = torch.zeros((9, 4, 3), **meta)
    w = torch.zeros((9, 3, 5), **meta)
    with pytest.raises(ValueError, match="expected CUDA"):
        spectral_matmul.spectral_matmul(x, x, w, w, w)


def test_kernel_counters_start_at_zero_and_cpu_path_does_not_count():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(4, 3, 16).astype(np.float32))
    planes = cc.spectral_cache(torch.ones((2, 3, 16)))
    kernels = (bc_fused.KERNEL, paged_attention.KERNEL, paged.KERNEL,
               spectral_matmul.KERNEL)
    before = [(kn.launches, dict(kn.fn_launches)) for kn in kernels]
    bc_fused.bc_fused_matmul(x, planes["wr"], planes["ws1"], planes["ws2"],
                             16)
    for bits in (8, 4):                          # the quantized lanes
        qp = codec.quantize_plane_cache(planes, bits)
        bc_fused.bc_fused_matmul(x, qp["wr"], qp["ws1"], qp["ws2"], 16,
                                 [qp[n + "_s"] for n in ("wr", "ws1", "ws2")])
        bc_fused.bc_fused4_matmul(x, qp["wr"], qp["wi"], 16,
                                  [qp["wr_s"], qp["wi_s"]])
    bc_fused.bc_fused4_matmul(x, planes["wr"], planes["wi"], 16)
    pool, sc = codec.quantize_page_block(torch.from_numpy(
        rng.randn(3, 4, 2, 16).astype(np.float32)))
    table = torch.tensor([[1, 2], [0, 0]], dtype=torch.int32)
    pos = torch.tensor([5, -1], dtype=torch.int32)
    paged_attention.paged_attention(torch.zeros((2, 4, 16)), pool, pool,
                                    table, pos, k_scale=sc, v_scale=sc)
    paged.paged_gather(pool, table)
    xs = torch.from_numpy(rng.randn(9, 4, 3).astype(np.float32))
    ws = torch.from_numpy(rng.randn(9, 3, 5).astype(np.float32))
    spectral_matmul.spectral_matmul(xs, xs, ws, ws, ws)
    # the plain versions ran: no count moved, on any lane
    assert [(kn.launches, kn.fn_launches) for kn in kernels] == before
    assert set(bc_fused.KERNEL.fn_launches) == {
        "bc_fused", "bc_fused_i8", "bc_fused_i4",
        "bc_fused4", "bc_fused4_i8", "bc_fused4_i4"}
    assert set(paged_attention.KERNEL.fn_launches) == {
        "paged_attention", "paged_attention_i8"}
    assert set(spectral_matmul.KERNEL.fn_launches) == {"spectral_matmul"}
