"""PyTorch / CUDA port of bloomscene_tpu for NVIDIA Hopper.

Module paths follow the JAX package (``config``, ``ops``, ``models``,
``scene``, ``pipeline``) so each piece has an obvious counterpart. The
package imports torch, numpy and the standard library only. Entry points
run on ``device="cuda"`` unless the caller passes ``device="cpu"``; on the
CPU every kernel wrapper takes its plain PyTorch version.
"""
