"""Numerics & quality health plane (port of ``repro/obs/health.py``;
docs/observability.md).

The paper's algorithm half is a fine-grained accuracy/compression
tradeoff; this module is the runtime's *accuracy* telemetry, the
counterpart to the latency/roofline planes of ``obs.metrics`` /
``obs.prof``.  Two host-side consumers live here:

* ``HealthPlane`` folds the fixed-shape numerics side-outputs of
  ``serve/decode.py`` (logit absmax / entropy / top1-margin, non-finite
  counts, per-layer-group activation absmax) into labelled histograms.
  The engine's binary NaN guard becomes the degenerate case: a guard trip
  always coincides with a ``health.nonfinite_*`` bump in the SAME
  dispatch, so the plane surfaces the anomaly at or before NaN-guard
  retirement by construction.
* ``ShadowOracle`` samples a fraction of FINISHED requests and
  teacher-force replays them through the float32 dense-cache oracle
  (``quant/calibrate.py``'s ``ParityRunner``), publishing online
  ``health.greedy_agreement`` / ``health.logit_drift``.  Replays run off
  the hot path (at most one per engine step, between dispatches) and the
  queue is bounded (drops are counted, never blocking).

The port's engines bake the serving planes into their weights in place,
so the oracle takes the engine's module as the quantized side and keeps a
second, float32-plane copy of it (``calibrate.fresh_serving_params``) for
the dense side, made at the first replay.

Import discipline: this module must NOT import ``repro_torch.serve`` or
``repro_torch.quant.calibrate`` at module scope (calibrate imports the
serve package, whose engine imports ``obs``), so those imports happen
lazily inside ``ShadowOracle``.

Left out: nothing.
"""
from __future__ import annotations

from collections import deque
from typing import Dict

import numpy as np

from .metrics import RATIO_BUCKETS

# Log-spaced bucket bounds for the numerics plane.  Activation/logit
# absmax for a healthy f32/int8 smoke model lives in O(0.1..100); the
# overflow bucket is the anomaly bin (an exploding datapath marches up
# the buckets before it hits inf — that drift is the alertable signal).
ABSMAX_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                  100.0, 250.0, 1000.0, 10000.0)
# entropy of a V-way softmax is [0, ln V]; ~11 covers V up to ~60k
ENTROPY_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 4.0, 6.0,
                   8.0, 11.0)
# top1-top2 logit margin: small margin = low-confidence greedy pick
MARGIN_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                  25.0, 100.0)
# KV page scales (absmax/qmax of activations) and logit drift magnitudes
SCALE_BUCKETS = (1e-4, 1e-3, 5e-3, 1e-2, 5e-2, 0.1, 0.25, 0.5, 1.0,
                 2.5, 10.0)
DRIFT_BUCKETS = (1e-4, 1e-3, 1e-2, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                 5.0, 10.0, 50.0)


class HealthPlane:
    """Host-side fold of the device numerics side-outputs.

    ``serve/decode.py`` packs per-dispatch stats as fixed-shape arrays
    (see ``logit_stats`` there for the column layout): the engine reads
    them back after the dispatch, then hands them here.  Rows that never
    took a finite step carry their init sentinels and are skipped; rows
    that produced non-finite logits bump the ``health.nonfinite_*``
    counters instead of polluting the histograms.
    """

    def __init__(self, registry):
        self._h = {}
        for phase in ("prefill", "decode"):
            self._h[phase] = {
                "absmax": registry.histogram("health.logit_absmax",
                                             bounds=ABSMAX_BUCKETS,
                                             phase=phase),
                "entropy": registry.histogram("health.logit_entropy",
                                              bounds=ENTROPY_BUCKETS,
                                              phase=phase),
                "margin": registry.histogram("health.top1_margin",
                                             bounds=MARGIN_BUCKETS,
                                             phase=phase),
            }
        self._h_act = registry.histogram("health.act_absmax",
                                         bounds=ABSMAX_BUCKETS,
                                         phase="prefill")
        self._g_act_peak = registry.gauge("health.act_absmax_peak")
        # nonfinite_logits counts bad VALUES; nonfinite_dispatches counts
        # (slot, dispatch) pairs that produced any — the NaN guard retires
        # at most one request per such pair, so dispatches >= guard trips.
        self._c_nonfinite = registry.counter("health.nonfinite_logits")
        self._c_nonfinite_d = registry.counter("health.nonfinite_dispatches")

    # -- folds -------------------------------------------------------------
    def on_prefill(self, stats: Dict) -> None:
        """Fold one prefill dispatch's stats (``logit`` (4,) and
        ``act_absmax``, host arrays)."""
        logit = np.asarray(stats["logit"], dtype=np.float64)
        absmax, ent, margin, nonf = (float(x) for x in logit)
        if nonf > 0 or not np.isfinite(absmax):
            self._c_nonfinite.inc(max(nonf, 1.0))
            self._c_nonfinite_d.inc()
        else:
            h = self._h["prefill"]
            h["absmax"].observe(absmax)
            if np.isfinite(ent):
                h["entropy"].observe(ent)
            if np.isfinite(margin):
                h["margin"].observe(margin)
        act = np.asarray(stats["act_absmax"], dtype=np.float64)
        finite = act[np.isfinite(act)]
        self._h_act.observe_many(finite)
        if finite.size:
            self._g_act_peak.set(max(self._g_act_peak.value,
                                     float(finite.max())))

    def on_decode(self, stats: np.ndarray, steps: np.ndarray) -> None:
        """Fold one decode dispatch's ``(B, 4)`` stats (columns 0-2 a
        first-step sample, column 3 the exact per-step non-finite count
        — see ``make_paged_decode_loop``).

        ``steps[b]`` is how many tokens slot ``b`` advanced this
        dispatch (0 for idle/halted slots — their rows are init
        sentinels or stale and are skipped)."""
        stats = np.asarray(stats, dtype=np.float64)
        steps = np.asarray(steps)
        bad = stats[:, 3] > 0
        if bad.any():
            self._c_nonfinite.inc(float(stats[bad, 3].sum()))
            self._c_nonfinite_d.inc(int(bad.sum()))
        h = self._h["decode"]
        rows = stats[steps > 0]
        for col, name in ((0, "absmax"), (1, "entropy"), (2, "margin")):
            v = rows[:, col]
            h[name].observe_many(v[np.isfinite(v)])

    # -- views -------------------------------------------------------------
    @property
    def nonfinite_dispatches(self) -> int:
        return int(self._c_nonfinite_d.value)

    def stats(self) -> Dict:
        return {
            "nonfinite_logits": int(self._c_nonfinite.value),
            "nonfinite_dispatches": int(self._c_nonfinite_d.value),
            "act_absmax_peak": self._g_act_peak.max_seen,
        }


class ShadowOracle:
    """Online quantization-quality sampling against the f32 oracle.

    A fraction ``sample`` of FINISHED requests is enqueued for
    teacher-forced replay: both the f32 dense-cache oracle and the
    serving (quantized paged) path consume the ORACLE's greedy token
    each step, so per-step greedy agreement and logit drift are
    well-defined — the same harness ``quant/calibrate.parity_report``
    runs offline, which is what pins the online numbers to the offline
    ones within measurement noise.

    ``health.greedy_agreement`` is the steps-weighted running mean
    (matching the offline harness's pooled-steps definition);
    ``health.logit_drift`` is the running max."""

    def __init__(self, cfg, params, *, policy, registry,
                 sample: float, seed: int = 0, page_size: int = 4,
                 max_pending: int = 16):
        self.cfg = cfg
        self._params = params
        self.policy = policy
        self.sample = float(sample)
        self.page_size = int(page_size)
        self.max_pending = int(max_pending)
        self._rng = np.random.RandomState(int(seed))
        self._queue: deque = deque()
        self._runner = None               # lazy: built on first replay
        self._agree_steps = 0.0
        self._agree_sum = 0.0
        self._drift = 0.0
        self._registry = registry
        self._c_sampled = registry.counter("health.shadow_sampled")
        self._c_replays = registry.counter("health.shadow_replays")
        self._c_dropped = registry.counter("health.shadow_dropped")
        # the agreement/drift gauges are created at the FIRST replay, not
        # here: a gauge born at 0.0 would breach the SLO agreement rule
        # (< 0.5) on every snapshot before any replay ran — absent series
        # never fire (obs/slo.py)
        self._g_agree = None
        self._g_drift = None
        self._h_agree = registry.histogram("health.shadow_agreement",
                                           bounds=RATIO_BUCKETS)
        self._h_drift = registry.histogram("health.shadow_drift",
                                           bounds=DRIFT_BUCKETS)

    # -- sampling ----------------------------------------------------------
    @property
    def pending(self) -> int:
        return len(self._queue)

    def maybe_enqueue(self, prompt, new_tokens: int) -> bool:
        """Coin-flip a finished request into the replay queue.  Bounded:
        a full queue drops (counted) rather than backing up the engine."""
        if self.sample <= 0.0 or self._rng.random_sample() >= self.sample:
            return False
        self._c_sampled.inc()
        if len(self._queue) >= self.max_pending:
            self._c_dropped.inc()
            return False
        self._queue.append((np.asarray(prompt), max(int(new_tokens), 1)))
        return True

    # -- replay ------------------------------------------------------------
    def tick(self) -> bool:
        """Replay at most ONE queued request (the engine calls this
        between dispatches — off the hot path)."""
        if not self._queue:
            return False
        self._replay(*self._queue.popleft())
        return True

    def drain(self) -> int:
        """Flush the whole queue (engine drain/generate exit), so short
        runs still publish agreement/drift."""
        n = 0
        while self._queue:
            self._replay(*self._queue.popleft())
            n += 1
        return n

    def _ensure_runner(self):
        if self._runner is None:
            # lazy: calibrate imports the serve package (module docstring)
            from ..quant.calibrate import ParityRunner, fresh_serving_params
            from ..serve.params import precompute_serving_params
            params_q = precompute_serving_params(self._params, self.cfg,
                                                 self.policy)
            params_o = fresh_serving_params(self._params, self.cfg)
            self._runner = ParityRunner(self.cfg, params_o, params_q,
                                        policy=self.policy,
                                        page_size=self.page_size)
        return self._runner

    def _replay(self, prompt: np.ndarray, new_tokens: int) -> None:
        r = self._ensure_runner().run(prompt, new_tokens)
        if self._g_agree is None:
            self._g_agree = self._registry.gauge("health.greedy_agreement")
            self._g_drift = self._registry.gauge("health.logit_drift")
        steps = max(int(r["steps"]), 1)
        self._agree_steps += steps
        self._agree_sum += float(r["greedy_agreement"]) * steps
        self._g_agree.set(self._agree_sum / self._agree_steps)
        self._drift = max(self._drift, float(r["max_logit_drift"]))
        self._g_drift.set(self._drift)
        self._h_agree.observe(float(r["greedy_agreement"]))
        self._h_drift.observe(float(r["max_logit_drift"]))
        self._c_replays.inc()

    # -- views -------------------------------------------------------------
    def stats(self) -> Dict:
        return {
            "sampled": int(self._c_sampled.value),
            "replays": int(self._c_replays.value),
            "dropped": int(self._c_dropped.value),
            "steps": int(self._agree_steps),
            "greedy_agreement": (self._agree_sum / self._agree_steps
                                 if self._agree_steps else None),
            "logit_drift": self._drift if self._agree_steps else None,
        }
