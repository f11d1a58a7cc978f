"""Hand-written Hopper kernels (CUDA C++ in ``bloomscene_tpu_torch/csrc``)
with their plain PyTorch versions, the counterparts of the JAX package's
``ops/pallas``. Each wrapper takes its plain version for CPU tensors and
launches its kernel (or raises) for CUDA tensors."""


def launch_counts() -> dict:
    """Each kernel wrapper's ``launches`` count, by the kernel's name. A
    wrapper counts the Python calls that launch its kernel, so a step
    captured in a CUDA graph counts once at its capture and not at its
    replays."""
    from .blend import blend_backward, blend_forward
    from .expand import expand_slab
    from .hashgrid_bwd import grid_scatter
    from .pairs import expand_pairs
    return {"pair_expansion": expand_pairs.launches,
            "slab_expansion": expand_slab.launches,
            "blend_forward": blend_forward.launches,
            "blend_backward": blend_backward.launches,
            "hashgrid_bwd": grid_scatter.launches}
