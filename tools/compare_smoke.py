#!/usr/bin/env python3
"""Compare the launch counts and greedy tokens of two ``chip_smoke.py``
outputs (JSON lines, e.g. the parent tree's and a change's).

    python3 tools/compare_smoke.py PARENT.jsonl CHANGE.jsonl

Every phase line is matched by (phase, arch, its order among lines of that
phase); within it, every field whose name counts launches (``launches``,
``*_per_pass``, ``launches_per_decode_step``) or holds generated tokens
(``tokens`` as a list or a dict of lists, ``tokens_card``, ``tokens_cpu``,
``sampled_seed*``) is compared, at any depth.  Prints one line per field
that differs or exists on one side only, then a count; exit 0 either way
(an expected difference is the reader's to judge).
"""
import json
import sys
from collections import Counter

TOKEN_KEYS = {"tokens", "tokens_card", "tokens_cpu", "sampled_seed1",
              "sampled_seed2"}


def wanted(key, value):
    if key == "launches" or key.endswith("_per_pass") or (
            key == "launches_per_decode_step"):
        return True
    if key in TOKEN_KEYS:
        return isinstance(value, (list, dict))     # not a token count
    return False


def fields(obj, path=()):
    """(path, value) of every wanted field, at any depth."""
    for key, value in obj.items():
        if wanted(key, value):
            yield path + (key,), value
        elif isinstance(value, dict):
            yield from fields(value, path + (key,))


def phases(path):
    seen, out = Counter(), {}
    for line in open(path):
        if not line.startswith("{"):
            continue
        obj = json.loads(line)
        if "phase" not in obj or obj["phase"] == "kernels":
            continue
        key = (obj["phase"], obj.get("arch"))
        out[key + (seen[key],)] = dict(fields(obj))
        seen[key] += 1
    return out


def main() -> int:
    a, b = phases(sys.argv[1]), phases(sys.argv[2])
    diffs = compared = 0
    for key in sorted(set(a) | set(b), key=str):
        fa, fb = a.get(key, {}), b.get(key, {})
        for path in sorted(set(fa) | set(fb)):
            compared += 1
            if fa.get(path) != fb.get(path):
                diffs += 1
                print(f"{key} {'.'.join(path)}: {fa.get(path)} -> "
                      f"{fb.get(path)}")
    print(f"{compared} fields compared, {diffs} differ")
    return 0


if __name__ == "__main__":
    sys.exit(main())
