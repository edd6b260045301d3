"""The training cell's harness on the CPU at a tiny size: a sound run is
correct; a step that leaves the state unchanged and a step that leaves
half the batch out are caught; the control (the reference in float8 in
the program's place) fails a limit that the program passes."""
import json
import time

import torch

from bench import calibrate


def run_train(root, seed, trace=0, seconds=1.0):
    from bench import run as run_mod
    return run_mod.run(["--workload", "tiny.train", "--seed", str(seed),
                        "--seconds", str(seconds), "--trace", str(trace)],
                       device=torch.device("cpu"), root=root,
                       clock0=time.perf_counter())


def test_a_training_run_is_correct(tiny_root):
    code, res = run_train(tiny_root, 2 ** 33 + 5)
    assert code == 0
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {"train_tps", "setup_s"}
    assert list(res["checks"]) == ["loss_gap", "first_grad_leaf_gap",
                                   "change_leaf_gap", "skipped_steps"]


def test_a_step_that_leaves_the_state_unchanged_is_caught(tiny_root,
                                                          monkeypatch):
    from repro_torch.optim import adamw

    def unchanged(grads, state, leaves, cfg, lr=None):
        return ([[t.detach().clone() for t in leaf.tensors]
                 for leaf in leaves], state)
    monkeypatch.setattr(adamw, "update", unchanged)
    code, res = run_train(tiny_root, 21)
    assert code == 0 and res["correct"] is False
    assert res["checks"]["change_leaf_gap"]["value"] > 0.9


def test_half_the_batch_left_out_is_caught(tiny_root, monkeypatch):
    from repro_torch.train import train_step as ts

    def half(batch, n):
        return [{k: v[:v.shape[0] // 2] for k, v in batch.items()}]
    monkeypatch.setattr(ts, "microbatches", half)
    code, res = run_train(tiny_root, 22)
    assert code == 0 and res["correct"] is False
    assert res["checks"]["loss_gap"]["value"] > 0.008


def test_the_control_and_the_faults_fail_the_limits(tiny_root):
    limits = json.loads((tiny_root / "bench" / "cells" / "tiny.train.json")
                        .read_text())
    for seed in (1, 2, 3):
        r = calibrate.train_readings(tiny_root, "tiny.train", seed,
                                     torch.device("cpu"), lambda: None)
        assert all(r["program"][k] <= limits[k] for k in limits), r
        for bad in ("control", "half_batch"):
            assert any(r[bad][k] > limits[k] for k in limits), (bad, r)


def test_only_the_numbers_a_cell_limits_are_compared():
    from bench.lib import train
    ref = {"losses": [2.0, 1.9], "grad_norms": {"a": 1.0, "b": 2.0},
           "change": {"a": 0.1, "b": 0.2}}
    rec = dict(ref, losses=[2.5, 1.9], grad_norms={"a": 1.0, "b": 2.2},
               skipped=0, steps=[(0.0, 1.0)])
    got = train.compare(rec, ref, {"first_grad_leaf_gap": 0.05,
                                   "change_leaf_gap": 0.01})
    assert list(got["checks"]) == ["first_grad_leaf_gap", "change_leaf_gap",
                                   "skipped_steps"]
    assert abs(got["checks"]["first_grad_leaf_gap"]["value"] - 0.1) < 1e-12
    assert got["correct"] is False
    assert train.numbers(rec, ref)["loss_gap"] == 0.5
