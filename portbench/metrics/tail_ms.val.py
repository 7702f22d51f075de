"""Median over the fenced groups of a validation group's device tail (run_tail_batch: box solve, dense alignment, re-solve), in ms,
between device fences."""

import statistics


def read(d):
    if d.get("kind") != "val_pass" or not d.get("stages"):
        return None
    return statistics.median(s["tail"] for s in d["stages"])
