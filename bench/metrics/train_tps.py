"""Tokens of the training steps that start and end in the window, over
the seconds from the first such step's start to the last one's end."""
from bench.lib import stats


def read(rec):
    if rec.get("kind") != "train" or not rec["steps"]:
        return None
    spans = rec["steps"]
    return stats.rate(rec["tokens_per_step"] * len(spans),
                      spans[-1][1] - spans[0][0])
