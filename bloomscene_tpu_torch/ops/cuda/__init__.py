"""Hand-written Hopper kernels (CUDA C++ in ``bloomscene_tpu_torch/csrc``)
with their plain PyTorch versions, the counterparts of the JAX package's
``ops/pallas``. Each wrapper takes its plain version for CPU tensors and
launches its kernel (or raises) for CUDA tensors."""


def wrappers() -> dict:
    """Each kernel's wrapper by the kernel's name; a wrapper counts its
    launches in ``launches``."""
    from .blend import blend_backward, blend_forward
    from .emission_sums import emission_sums
    from .expand import expand_slab
    from .gather_rows_bwd import gather_rows_bwd
    from .hashgrid_bwd import grid_scatter
    from .hashgrid_encode import hashgrid_encode, hashgrid_encode_bwd
    from .pairs import expand_pairs
    from .stamp import stamp
    return {"pair_expansion": expand_pairs, "slab_expansion": expand_slab,
            "blend_forward": blend_forward, "blend_backward": blend_backward,
            "hashgrid_bwd": grid_scatter, "gather_rows_bwd": gather_rows_bwd,
            "hashgrid_encode": hashgrid_encode,
            "hashgrid_encode_bwd": hashgrid_encode_bwd, "stamp": stamp,
            "emission_sums": emission_sums}


def reset_launch_counts() -> None:
    """Set every kernel wrapper's ``launches`` count to 0."""
    for fn in wrappers().values():
        fn.launches = 0


def launch_counts() -> dict:
    """Each kernel wrapper's ``launches`` count, by the kernel's name. A
    wrapper counts the Python calls that launch its kernel, so a step
    captured in a CUDA graph counts once at its capture and not at its
    replays."""
    return {name: fn.launches for name, fn in wrappers().items()}


def loop_launches(counts: dict, graph_log: list) -> dict:
    """Each kernel's launches in a run of the device loop, every replay of
    a graph counted: ``counts`` (``launch_counts`` after the run) holds
    each capture's launches once, and the eager steps' and the renders';
    a captured launch runs once a replay (``Trainer.graph_log``)."""
    out = dict(counts)
    for g in graph_log:
        for name, n in g["launches"].items():
            out[name] += n * (g["replays"] - 1)
    return out
