"""Plain PyTorch references of the benchmark's configurations, in f32 with
TF32 off. They import torch and ``hexabench.inputs`` only: nothing of the
program (``repro_torch``), of the JAX package or of JAX."""
