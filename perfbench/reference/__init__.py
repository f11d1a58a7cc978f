"""The plain reference of a training step: frozen copies of the port's
plain PyTorch modules (the code its CPU path runs and its tests hold
against the JAX package), with every hand-written kernel replaced by its
plain version (``plain.py``: the pair and slab expansions as torch
chains, the blend's forward and backward as per-slot recurrences over all
tiles, the row sums as ``index_add``, the hash grid as eager torch). The
copies keep the port's docstrings, which speak of the port's files; where
they describe a kernel path, the copy takes the plain path. Nothing here
imports the port, and nothing is taken from a run of it: ``step.follow``
builds its own model from the benchmark's weights and works out again the
bounds, the visibility, the compaction, the bins and the gradients.
Precision is the caller's: float32 with TF32 off, or TF32 on for the
precision control."""
