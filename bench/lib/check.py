"""What decides ``correct``: the timed path's own output against the plain
reference, once the window has closed and the program's state is freed.

Serving: a sample drawn from the seed of the requests that finished in
the window, the one with the most served tokens among them.  The
reference runs once over each prompt with its served tokens (the weights
made again from the seed), and each served token is judged by its gap:
how far its logit lies below the reference's best at its position.  The
widest gap over every judged token is held to the cell's limit.  Besides,
every request that finished in the window has to end on its budget with
exactly its budget of tokens.

The control puts the reference in the program's place, computed in
float8 (``round_to``), and reads the gap of the token that lower
precision puts first, at the same positions (``served_gaps(...,
control=True)``).  ``serve_verdict(..., control=True)`` holds that gap
to the cell's limit in the program's place; the calibration runs it, the
benchmark's runs do not.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from . import model, traffic

FINISHED = ("FINISHED_BUDGET", "FINISHED_EOS")


def sample(rec: Dict, n: int) -> List:
    """The requests the reference judges: the finished one with the most
    served tokens, and ``n - 1`` more drawn from the seed."""
    done = sorted((tr for tr in rec["finished"] if tr.status in FINISHED),
                  key=lambda tr: tr.order)
    if not done:
        return []
    longest = max(done, key=lambda tr: (len(tr.tokens), -tr.order))
    rest = [tr for tr in done if tr is not longest]
    rng = traffic.seed_rng(rec["seed"] ^ 0xC4EC)
    pick = rng.permutation(len(rest))[:max(0, n - 1)]
    return [longest] + [rest[i] for i in sorted(pick)]


def served_gaps(ref, cfg: Dict, weights, tracks, device,
                control: bool = False) -> Tuple[float, int, float]:
    """(widest gap of a served token, tokens judged, widest gap of the
    control's first choice or nan) over ``tracks``."""
    widest, judged, ctl = 0.0, 0, float("nan")
    for tr in tracks:
        S = len(tr.prompt)
        seq = list(map(int, tr.prompt)) + list(tr.tokens[:-1])
        toks = torch.tensor(seq, dtype=torch.long, device=device)
        served = torch.tensor(tr.tokens, dtype=torch.long, device=device)
        with torch.no_grad():
            lg = ref.forward(weights, cfg, toks, S - 1)
            best = lg.max(dim=-1).values
            gap = best - lg.gather(1, served[:, None])[:, 0]
            widest = max(widest, float(gap.max()))
            judged += int(served.numel())
            if control:
                lc = ref.forward(weights, cfg, toks, S - 1,
                                 round_to=ref.fp8_rows)
                pick = lc.argmax(dim=-1)
                cg = float((best - lg.gather(1, pick[:, None])[:, 0]).max())
                ctl = cg if ctl != ctl else max(ctl, cg)
            del lg
    return widest, judged, ctl


def serve_verdict(rec: Dict, ref, limits: Dict, device,
                  control: bool = False) -> Dict:
    """``correct``, ``attempted``, ``failed`` and the numbers compared,
    each with its limit, of one serving run.  With ``control`` the gap
    compared is the control's, and the program's is kept beside the
    verdict as ``program_gap``."""
    t0, t1 = rec["t_open"], rec["t_close"]
    active = [tr for tr in rec["tracks"] if tr.submit_t <= t1
              and (tr.end_t is None or tr.end_t >= t0)]
    failed = sum(1 for tr in active
                 if tr.status is not None and tr.status not in FINISHED)
    bad = sum(1 for tr in rec["finished"]
              if tr.status != "FINISHED_BUDGET" or len(tr.tokens) != tr.budget)
    picked = sample(rec, int(rec["mix"]["check"]["requests"]))
    weights = model.make_weights(rec["cfg"], rec["seed"], device)
    gap, judged, ctl = served_gaps(ref, rec["cfg"], weights, picked, device,
                                   control=control)
    del weights
    checks = {
        "max_logit_gap": {"value": ctl if control else gap,
                          "limit": limits["max_logit_gap"], "rule": "<="},
        "bad_endings": {"value": bad, "limit": 0, "rule": "<="},
        "judged_tokens": {"value": judged,
                          "limit": limits["min_judged_tokens"], "rule": ">="},
    }
    out = {"correct": all(_holds(c) for c in checks.values()),
           "attempted": len(active), "failed": failed, "checks": checks}
    if control:
        out["program_gap"] = gap
    return out


def _holds(c: Dict) -> bool:
    return (c["value"] <= c["limit"] if c["rule"] == "<="
            else c["value"] >= c["limit"])
