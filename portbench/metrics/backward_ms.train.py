"""Median over the fenced steps of a training step's backward, in ms,
between device fences."""

import statistics


def read(d):
    if d.get("kind") != "train_loop" or not d.get("stages"):
        return None
    return statistics.median(s["backward"] for s in d["stages"])
