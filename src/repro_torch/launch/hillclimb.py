"""Perf hillclimb (port of ``repro/launch/hillclimb.py``): trace one
cell under a named variant with the dry run (``launch/dryrun.py``) and
print its roofline terms on the ``h100`` spec.

``VARIANTS`` are ``repro``'s fourteen, with the same knobs: the config and
compression fields they set, the sharding strategy, the dense baseline.
Each runs ``repro``'s exact-cost setting (``accum=0``: one batch, no
microbatches) on the single-pod (16, 16) mesh of a fake 256-rank process
group started in this process.  What ``repro``'s exact-cost lowering also
changes (unrolled scans, single-chunk attention) the port's trace needs
not: it runs every layer and every step once each.  The records are the
dry run's, which trace the step the card runs (each kernel launch a
stand-in charging the kernel's own FLOPs and bytes); a variant the card's
kernels refuse fails with their error.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
      --arch tinyllama-1.1b --shape decode_32k --variant nogauss,fuse
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Optional

from ..configs.registry import get_config
from ..roofline import analysis as roofline
from . import dryrun, mesh as mesh_lib

VARIANTS = {
    # paper-faithful baseline (same knobs the roofline sweep uses)
    "baseline": dict(),
    # paper-faithful WITHOUT the Gauss 3-mult trick (the pure-paper MAC count)
    "nogauss": dict(comp=dict(gauss_trick=False)),
    # beyond-paper: fused q/k/v + gate/up DFT pipelines
    "fuse": dict(comp=dict(fuse_projections=True)),
    # beyond-paper: no remat (flops down ~25%, memory up)
    "noremat": dict(cfg=dict(remat="none")),
    "fuse_noremat": dict(comp=dict(fuse_projections=True),
                         cfg=dict(remat="none")),
    # beyond-paper: token-parallel layout (weights replicated over "model",
    # sequence sharded over it) — kills TP collectives on compressed layers
    "tokenpar": dict(strategy="tokenpar"),
    "fuse_tokenpar": dict(comp=dict(fuse_projections=True),
                          strategy="tokenpar"),
    # block-size sensitivity (transform cost ∝ n·k, MAC ∝ n²/k)
    "k64": dict(comp=dict(block_ffn=64, block_attn=64, block_expert=64)),
    "k256": dict(comp=dict(block_ffn=256, block_attn=256, block_expert=256)),
    # decode: f8 KV cache (halves the cache-read memory term)
    "kvf8": dict(cfg=dict(kv_cache_dtype="float8_e4m3fn")),
    "kvf8_fuse": dict(cfg=dict(kv_cache_dtype="float8_e4m3fn"),
                      comp=dict(fuse_projections=True)),
    # combined best-of for train cells
    "best": dict(comp=dict(fuse_projections=True), cfg=dict(remat="none"),
                 strategy="tokenpar"),
    "kvf8_tokenpar": dict(cfg=dict(kv_cache_dtype="float8_e4m3fn"),
                          strategy="tokenpar"),
    # dense reference (the paper's uncompressed baseline)
    "dense": dict(compress=False),
}


def variant_config(arch: str, variant: str, cfg=None):
    """The config of ``arch`` (or ``cfg``) under ``variant``'s knobs."""
    spec = VARIANTS[variant]
    if cfg is None:
        cfg = get_config(arch, compress=spec.get("compress", True))
    elif not spec.get("compress", True):
        cfg = cfg.replace(compression=dataclasses.replace(
            cfg.compression, enabled=False))
    if "comp" in spec:
        cfg = cfg.replace(compression=dataclasses.replace(
            cfg.compression, **spec["comp"]))
    if "cfg" in spec:
        cfg = cfg.replace(**spec["cfg"])
    return cfg


def run_variant(arch: str, shape: str, variant: str, accum: int = 0,
                mesh=None, cfg=None):
    """One variant's record (``repro``'s keys, ``h100`` terms).  ``mesh``
    defaults to the single-pod production mesh; ``cfg`` (a config to
    start from, e.g. a reduced one) to ``arch``'s."""
    spec = VARIANTS[variant]
    cfg = variant_config(arch, variant, cfg)
    if mesh is None:
        mesh = mesh_lib.make_production_mesh(multi_pod=False, device="cpu")
    strategy = spec.get("strategy", "megatron")
    rec = {"arch": arch, "shape": shape, "variant": variant,
           "strategy": strategy}
    t0 = time.time()
    try:
        record, meta = dryrun.lower_cell(
            arch, shape, mesh, strategy,
            compress=spec.get("compress", True), accum=accum,
            cfg_override=cfg)
        if record is None:
            raise ValueError(f"cell does not apply: {meta['skipped']}")
        rec.update(roofline.cell_report(record, meta["cfg"], meta["shape"],
                                        mesh, params=meta["params"]))
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["trace"] = traceback.format_exc()[-1500:]
    rec["wall_s"] = round(time.time() - t0, 1)
    return rec


def line(variant: str, rec) -> str:
    """``repro``'s printed line of one record."""
    if rec["status"] != "ok":
        return f"{variant}: FAIL {rec['error']}"
    return (f"{variant}: compute={rec['compute_s']*1e3:.1f}ms "
            f"memory={rec['memory_s']*1e3:.1f}ms "
            f"collective={rec['collective_s']*1e3:.1f}ms "
            f"dom={rec['dominant']} mhr={rec['model_hlo_ratio']:.3f} "
            f"roof={rec['roofline_frac_overlap']:.3f} "
            f"({rec['wall_s']}s)")


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", required=True,
                    help=f"comma list of {sorted(VARIANTS)}")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    dryrun.start_fake_group(256)
    recs = []
    existing = []
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            existing = json.load(f)
    for v in args.variant.split(","):
        rec = run_variant(args.arch, args.shape, v)
        recs.append(rec)
        if args.out:                          # incremental: survive kills
            with open(args.out, "w") as f:
                json.dump(existing + recs, f, indent=1)
        print(line(v, rec), flush=True)


if __name__ == "__main__":
    main()
