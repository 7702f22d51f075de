"""side_tpu_torch: the PyTorch / CUDA (Hopper) port of side_tpu.

The JAX package `side_tpu` stays the reference; this package imports
nothing of it and nothing of JAX.  `runtime.detector.Detector` runs the
flagship stereo detector (DLA-34 + DCN, cost-volume depth, fused device
tail) on a CUDA device; `runtime.trainer.Trainer` and `python -m
side_tpu_torch.train` train it.  The deformable convolution is hand-written
for Hopper: csrc/dcn_fwd.cu (forward) and csrc/dcn_bwd.cu (backward).
"""
