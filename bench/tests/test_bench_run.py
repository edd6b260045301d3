"""Whole runs of the tiny cell on the CPU (the look for a card skipped),
the refusals, the control against the limit, and a token altered where
it is produced."""
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from conftest import ROOT


def run_tiny(root, seed, trace=0, seconds=1.0):
    from bench import run as run_mod
    return run_mod.run(["--workload", "tiny.chat", "--seed", str(seed),
                        "--seconds", str(seconds), "--trace", str(trace)],
                       device=torch.device("cpu"), root=root,
                       clock0=time.perf_counter())


def test_a_run_is_correct_and_reports_its_metrics(tiny_root):
    code, res = run_tiny(tiny_root, 2 ** 32 + 17)
    assert code == 0
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {"output_tps", "ttft_p90_ms",
                                   "itl_p95_ms", "setup_s"}
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert res["checks"]["judged_tokens"]["value"] >= 5


def test_a_traced_run_reads_no_device_metric_without_a_device(tiny_root):
    code, res = run_tiny(tiny_root, 5, trace=1, seconds=1.5)
    assert code == 0 and res["correct"] is True
    assert res["metrics"] == {}              # nothing ran on a device
    assert "breakdown" not in res


def test_an_altered_token_is_caught(tiny_root, monkeypatch):
    from repro_torch.serve import decode
    real = decode.greedy
    calls = {"n": 0}

    def altered(logits):
        calls["n"] += 1
        tok = real(logits)
        if calls["n"] % 3 == 0:              # every third step's tokens
            return (tok + 1) % logits.shape[-1]
        return tok
    monkeypatch.setattr(decode, "greedy", altered)
    code, res = run_tiny(tiny_root, 11)
    assert code == 0
    assert res["correct"] is False
    assert res["checks"]["max_logit_gap"]["value"] > 0.02


def test_a_prefill_that_leaves_the_pool_unchanged_is_caught(tiny_root,
                                                           monkeypatch):
    """The prefill's keys and values never reach the paged pool: the
    state the decode steps read is returned unchanged."""
    from repro_torch.serve import kvcache

    def unchanged(pool, dense_cache, pages, page_size, true_len=None,
                  with_stats=False):
        if not with_stats:
            return pool
        zero = torch.zeros((), dtype=torch.float32)
        return pool, zero, zero
    monkeypatch.setattr(kvcache, "pack_prefill_cache", unchanged)
    code, res = run_tiny(tiny_root, 12)
    assert code == 0
    assert res["correct"] is False
    assert res["checks"]["max_logit_gap"]["value"] > 0.02


def test_the_control_fails_the_limit(tiny_root):
    """The reference in float8 in the program's place fails the cell's
    limit on every seed tried, through the run's own verdict, and the
    program passes it."""
    from bench import calibrate
    limit = json.loads((tiny_root / "bench" / "cells" / "tiny.chat.json")
                       .read_text())["max_logit_gap"]
    for seed in (1, 2, 3):
        r = calibrate.readings(tiny_root, "tiny.chat", seed, 1.0,
                               torch.device("cpu"), lambda: None)
        assert r["program_gap"] <= limit < r["control_gap"], r
        assert r["control_correct"] is False


def _python(args, cwd, env=None):
    e = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    e.update(env or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=e,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    p = _python(["bench/run.py", "--workload", "qwen3-4b.chat", "--seed",
                 "1", "--seconds", "1", "--trace", "0"], ROOT,
                {"CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode == 2 and p.stdout == ""


def test_without_the_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time, torch; sys.path.insert(0, '.');"
            "from bench import run;"
            "c, r = run.run(['--workload', 'qwen3-4b.chat', '--seed', '1',"
            "'--seconds', '1'], device=torch.device('cpu'), root='.');"
            "print(r)")
    p = _python(["-c", code], tmp_path)
    assert p.returncode != 0 and p.stdout == ""
    assert "repro_torch" in p.stderr


def test_nothing_of_jax_or_repro_is_loaded(tiny_root):
    """Every module a run and the reference load, by whole top-level name:
    neither jax nor repro (repro_torch is not repro); the reference loads
    nothing of repro_torch either."""
    code = ("import sys, time, torch; sys.path.insert(0, %r);"
            "sys.path.insert(0, %r);"
            "from bench import run;"
            "c, r = run.run(['--workload', 'tiny.chat', '--seed', '3',"
            "'--seconds', '0.5'], device=torch.device('cpu'), root=%r);"
            "assert c == 0 and r['correct'];"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"
            % (str(ROOT), str(ROOT / "src"), str(tiny_root)))
    p = _python(["-c", code], ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    tops = set(p.stdout.split())
    assert "repro_torch" in tops and "bench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}
    ref = ("import sys; sys.path.insert(0, %r);"
           "from bench.lib.spec import load_module;"
           "load_module(%r, 'ref');"
           "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"
           % (str(ROOT), str(ROOT / "bench" / "configs" / "circulant_lm.py")))
    p = _python(["-c", ref], ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    tops = set(p.stdout.split())
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = _python(["bench/run.py", "--workload", "qwen3-4b.chat", "--seed",
                 str(2 ** 31 + 99), "--seconds", "20", "--trace", "0"], ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True
