"""A tiny size of every cell, at which the harness runs on the CPU: the
program's plain CPU path and the reference, both in float32."""

CONFIG = {"input_h": 64, "input_w": 128, "compute_dtype": "float32",
          "max_objs": 8, "roi_size": 4, "K": 8, "cv_topk": 4,
          "align_topk": 4}
MIX = {
    "train_loop": {"pairs_per_step": 2, "pool_batches": 4, "trace_steps": 2,
                   "stage_steps": 2},
    "val_pass": {"eval_batch": 2, "pool_frames": 4, "warmup_groups": 1,
                 "trace_groups": 1, "stage_groups": 1},
}
SEED = 2 ** 31 + 977


def overrides(kind: str) -> dict:
    return {"config_overrides": dict(CONFIG),
            "mix_overrides": dict(MIX[kind])}


def kind_of(workload: str) -> str:
    return "val_pass" if workload.startswith("val.") else "train_loop"
