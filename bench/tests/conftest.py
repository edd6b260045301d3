"""The benchmark's CPU tests: a checkout cut down to a tiny cell.

``tiny_root`` builds, in a temporary directory, a checkout that holds a
copy of ``bench/`` and a ``BENCHMARK.json`` naming one tiny configuration
(``qwen3-4b``'s layer kinds at widths a CPU runs in seconds, marked
``cut_below_port``), one tiny open-loop mix and its limits, every one
written as a new file there: the harness finds each by name; and a tiny
training mix beside it.
"""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

TINY_CONFIG = {
    "hidden_size": 128, "intermediate_size": 256, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 32,
    "vocab_size": 384, "vocab_multiple": 128, "eos_token_id": 1,
    "cut_below_port": True,
}
TINY_MIX = {
    "kind": "serve",
    "arrivals": {"kind": "poisson", "rate": 20.0},
    "initial_requests": 2,
    "requests": 16,
    "block": 4,
    "prompt": {"dist": "lognormal", "median": 12, "sigma": 0.5, "lo": 4,
               "hi": 30},
    "output": {"dist": "lognormal", "median": 5, "sigma": 0.4, "lo": 3,
               "hi": 9},
    "engine": {"max_slots": 3, "max_seq": 48, "page_size": 8,
               "decode_chunk": 4, "kv_dtype": "bf16"},
    "ramp_s": 0.2,
    "trace": {"after_s": 0.1, "slice_s": 0.3},
    "check": {"requests": 3},
}
TINY_TRAIN = {
    "kind": "train", "batch": 2, "seq": 32, "docs": 32,
    "documents": {"dist": "lognormal", "median": 12, "sigma": 1.0, "lo": 4,
                  "hi": 32},
    "optimizer": {"lr": 3e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
                  "weight_decay": 0.1, "grad_clip": 1.0},
    "checked_steps": 3,
    "trace": {"steps": 2},
}


def make_root(tmp: Path, base: str = "qwen3-4b", patches: int = 0) -> Path:
    """A checkout at ``tmp`` with the tiny cells ``tiny.chat`` and
    ``tiny.train``."""
    shutil.copytree(ROOT / "bench", tmp / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.loads((ROOT / "bench" / "configs" / f"{base}.json")
                     .read_text())
    cfg.update(TINY_CONFIG)
    cfg["block_circulant"] = dict(cfg["block_circulant"], block_attn=16,
                                  block_ffn=16)
    cfg["frontend"] = dict(cfg["frontend"], num_patches=patches)
    (tmp / "bench" / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (tmp / "bench" / "traffic" / "tiny_chat.json").write_text(
        json.dumps(TINY_MIX))
    (tmp / "bench" / "cells" / "tiny.chat.json").write_text(json.dumps(
        {"max_logit_gap": 0.02, "min_judged_tokens": 5}))
    (tmp / "bench" / "traffic" / "tiny_train.json").write_text(
        json.dumps(TINY_TRAIN))
    (tmp / "bench" / "cells" / "tiny.train.json").write_text(json.dumps(
        {"loss_gap": 0.008, "first_grad_leaf_gap": 0.006,
         "change_leaf_gap": 0.015}))
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    doc["configs"] = [{"name": "tiny", "source": "a test",
                       "file": "bench/configs/tiny.json", "reduced": [],
                       "why": "a test"}]
    doc["workloads"] = [{"name": "tiny.chat", "config": "tiny",
                         "traffic": "tiny_chat", "chips": 1,
                         "why": "a test"},
                        {"name": "tiny.train", "config": "tiny",
                         "traffic": "tiny_train", "chips": 1,
                         "why": "a test"}]
    for m in doc["end_to_end"] + doc["per_layer"]:
        m.pop("workloads", None)
    (tmp / "BENCHMARK.json").write_text(json.dumps(doc))
    return tmp


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
