"""The share of a chunk boundary's device idle time that the program's
named host spans cover (``loop.*``, the stamps placed on the host's
clock by the run's offset): 100 less ``host_ms["unnamed"]`` over
``boundary_idle_ms``."""
from perfbench.stamps import per_chunk


def share(c):
    idle, unnamed = c.get("boundary_idle_ms"), c.get("host_ms", {}).get(
        "unnamed")
    if idle is None or unnamed is None or idle <= 0:
        return None
    return 100.0 * (idle - unnamed) / idle


def read(ctx):
    return per_chunk(ctx, share)
