"""side_tpu_torch: the PyTorch / CUDA (Hopper) port of side_tpu.

The JAX package `side_tpu` stays the reference; this package imports
nothing of it and nothing of JAX.  Inference slice: `runtime.detector.
Detector` runs the flagship stereo detector (DLA-34 + DCN, cost-volume
depth, fused device tail) on a CUDA device, with the deformable
convolution as a hand-written Hopper kernel (csrc/dcn_fwd.cu).
"""
