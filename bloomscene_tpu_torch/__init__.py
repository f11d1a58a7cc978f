"""PyTorch / CUDA port of bloomscene_tpu for NVIDIA Hopper.

Module paths follow the JAX package (``config``, ``ops``, ``models``,
``train``, ``codec``, ``scene``, ``priors``, ``pipeline``, ``utils``) so
each piece has an obvious counterpart. The package imports torch, numpy
and the standard library, and scipy in the host-side generation
(``pipeline/pcdgen.py`` and the stub priors); imageio and matplotlib are
optional (the mp4 writer, the depth colormap), and PIL is imported only by
the real-prior adapters. Entry points run on ``device="cuda"`` unless the
caller passes ``device="cpu"``; on the CPU every kernel wrapper takes its
plain PyTorch version.
"""
