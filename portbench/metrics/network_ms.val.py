"""Median over the fenced groups of a validation group's network (Detector.network), in ms,
between device fences."""

import statistics


def read(d):
    if d.get("kind") != "val_pass" or not d.get("stages"):
        return None
    return statistics.median(s["network"] for s in d["stages"])
