"""Start the ranks of a mesh on one machine, and wait for them.

Nothing tells a program of a cluster here, so ``spawn`` starts
``world_size`` processes itself (multiprocessing's ``spawn`` start
method: fresh interpreters, safe with CUDA), each calling
``fn(rank, world_size, *args)``; ``fn`` joins the process group with
``init_distributed`` (a ``file://`` store is the simplest rendezvous on
one machine). Each rank is joined under the one deadline; a rank that
exits nonzero or is still running at the deadline makes ``spawn`` stop
every rank and raise, so a hang or a failure is never taken for a
result.
"""
from __future__ import annotations

import multiprocessing as mp
import time


def spawn(fn, world_size: int, args: tuple = (),
          timeout: float = 120.0) -> None:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` fresh
    processes (``fn`` importable by its module and name) and wait at most
    ``timeout`` seconds for all of them. Raises RuntimeError naming the
    ranks that failed or timed out; every process is stopped before this
    returns or raises."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=fn, args=(rank, world_size, *args),
                         name=f"rank{rank}") for rank in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        late = [p.name for p in procs if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    failed = [f"{p.name} (exit {p.exitcode})" for p in procs
              if p.name not in late and p.exitcode != 0]
    if late or failed:
        raise RuntimeError(
            f"ranks failed: {failed}; ranks still running after "
            f"{timeout:.0f} s (stopped): {late}")
