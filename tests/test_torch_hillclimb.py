"""The port's hillclimb (``launch/hillclimb.py``) against
``repro``'s: the same fourteen variants with the same knobs, and every one
of them traced to an ``ok`` record (with ``repro``'s printed line) on a
smoke decode cell and a smoke train cell of tinyllama on a (2, 4) mesh,
in a subprocess that starts its own fake process group of 8 ranks (the
suite's workers hold a one-rank gloo group already)."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import hillclimb  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _repro_variants():
    """``repro``'s ``VARIANTS``, read from its source (importing its
    module would set ``XLA_FLAGS`` for this process)."""
    src = (ROOT / "src" / "repro" / "launch" / "hillclimb.py").read_text()
    for node in ast.parse(src).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", "") == "VARIANTS" for t in node.targets):
            return eval(compile(ast.Expression(node.value), "VARIANTS",
                                "eval"), {"dict": dict})
    raise AssertionError("no VARIANTS in repro's hillclimb")


def test_variants_equal_repro():
    """``repro``'s variants, knob for knob (there are fourteen)."""
    want = _repro_variants()
    assert hillclimb.VARIANTS == want and len(want) == 14


_PROBE = r"""
import sys, json
sys.path[:0] = [{src!r}]
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch import dryrun, hillclimb, mesh as mesh_lib
dryrun.start_fake_group(8)
mesh = mesh_lib.make_mesh((2, 4), ("data", "model"), device="cpu")
cfg = get_smoke_config("tinyllama-1.1b")
out = {{}}
for shape in ("decode_32k", "train_4k"):
    for v in hillclimb.VARIANTS:
        rec = hillclimb.run_variant("tinyllama-1.1b", shape, v, mesh=mesh,
                                    cfg=cfg)
        out[shape + "/" + v] = [rec["status"], rec.get("error", ""),
                                hillclimb.line(v, rec),
                                rec.get("hardware"), rec.get("strategy"),
                                rec.get("collectives"),
                                rec.get("memory", {{}}).get("argument_bytes")]
print("RESULT", json.dumps(out))
"""


@pytest.fixture(scope="module")
def variants_run():
    p = subprocess.run(
        [sys.executable, "-c", _PROBE.format(src=str(ROOT / "src"))],
        capture_output=True, text=True, timeout=900)
    line = [ln for ln in p.stdout.splitlines() if ln.startswith("RESULT ")]
    assert line, p.stdout[-2000:] + p.stderr[-4000:]
    return json.loads(line[-1][len("RESULT "):])


@pytest.mark.parametrize("shape", ["decode_32k", "train_4k"])
def test_every_variant_traces_ok(variants_run, shape):
    for v, spec in hillclimb.VARIANTS.items():
        status, err, text, hw, strategy, _, _ = variants_run[f"{shape}/{v}"]
        assert status == "ok", (v, err)
        assert text.startswith(f"{v}: compute=") and " dom=" in text
        assert hw == "h100"
        assert strategy == spec.get("strategy", "megatron")


# the decode step's fused q/k/v and up/gate outputs gathered over the model
# axis before the split: a data shard's 64 rows of 3 x 128 + 2 x 256
# bfloat16 columns, 2 layers (as tests/test_torch_dryrun.py counts them)
FUSED_ACTIVATION_GATHER = 64 * (3 * 128 + 2 * 256) * 2 * 2


def test_fuse_variants_shard_like_baseline(variants_run):
    """``fuse`` against ``baseline`` on the (2, 4) mesh: in training the
    separate generators run as Megatron's fused QKV (each rank's own
    output blocks, each output sharded), with the baseline's collectives
    to the byte; at decode the fused caches hold the baseline's argument
    bytes (sharded as the rules shard them, no weight gathered over
    "model") and add only the all-gather of the fused outputs."""
    base, fuse = (variants_run[f"train_4k/{v}"] for v in ("baseline",
                                                            "fuse"))
    assert fuse[5] == base[5] and fuse[6] == base[6]
    base, fuse = (variants_run[f"decode_32k/{v}"] for v in ("baseline",
                                                              "fuse"))
    assert fuse[6] == base[6]
    want = dict(base[5])
    want["all-gather"] += FUSED_ACTIVATION_GATHER
    want["total"] += FUSED_ACTIVATION_GATHER
    assert fuse[5] == want
