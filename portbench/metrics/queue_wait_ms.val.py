"""How long a pre-processed frame waits for its group's dispatch: the
median over the frames of the run's first profiled validation pass (a
traced run profiles two, device activity only and then with the host's;
the first keeps the host at its untraced pace) of the time from the end of
a frame's `val.pre` to the start of its group's `val.dispatch`, both from
the program's span buffer, on one clock; in ms."""

import statistics

from portbench.metrics.spans import pre_calls, queue_waits_ms


def read(d):
    if d.get("kind") != "val_pass" or d.get("device") != "cuda":
        return None
    calls = pre_calls()
    if not calls or len(calls) < 2:
        return None
    waits = queue_waits_ms(calls[-2])
    return statistics.median(waits) if waits else None
