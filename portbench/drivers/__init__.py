"""The drivers of the traffic kinds: each sets up its cell, measures the
window, collects what the per-layer readers read, and checks what the
timed path produced against the reference.  They are the benchmark's only
code that calls the program (side_tpu_torch)."""
