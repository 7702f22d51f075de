"""Median over the fenced steps of a training step's forward + loss, in ms,
between device fences."""

import statistics


def read(d):
    if d.get("kind") != "train_loop" or not d.get("stages"):
        return None
    return statistics.median(s["forward"] for s in d["stages"])
