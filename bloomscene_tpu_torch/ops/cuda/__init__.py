"""Hand-written Hopper kernels (CUDA C++ in ``bloomscene_tpu_torch/csrc``)
with their plain PyTorch versions, the counterparts of the JAX package's
``ops/pallas``. Each wrapper takes its plain version for CPU tensors and
launches its kernel (or raises) for CUDA tensors."""
