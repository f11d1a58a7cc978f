"""The hash-grid encoder's kernel path on the CPU: the port's ``mix_encode``
against the JAX package's, and the backward kernel's torch twin
(``mix_encode_backward_plain``) against autograd through the eager code.

On the card ``mix_encode`` is ``_MixEncode`` (``csrc/hashgrid_encode.cu``);
on the CPU its wrappers take their plain versions: the eager code for the
forward, the twin for the backward. So ``_MixEncode`` here runs the
kernel's algorithm end to end.

Tolerances: the forward bitwise JAX's (op by op, at the default widths,
config.py:132-137). The backward's corner rows and table indices bitwise
the rows autograd hands ``grid_scatter``, so the table gradients are the
same bits. The gradient to x: the twin sums each corner's F features in
the order of torch's CUDA reduction ((t0 + t2) + (t1 + t3)), the CPU
reduction sums them in order (((t0 + t1) + t2) + t3); so here it is held
within HASHGRID_DX_RTOL (1e-6) of the summed magnitudes of its terms, and
with the CPU's order patched in, bitwise, which shows that every other sum
runs in autograd's order. A planted fault (one corner's weight left out
of the normalizer) fails both.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bloomscene_tpu.config import GSConfig as JaxConfig
from bloomscene_tpu.models.model import mix_spec as jax_mix_spec
from bloomscene_tpu.ops import hashgrid as jh
from bloomscene_tpu_torch.config import GSConfig
from bloomscene_tpu_torch.models.model import mix_spec
from bloomscene_tpu_torch.ops import hashgrid as th
from chip_smoke import HASHGRID_DX_RTOL, hashgrid_dx_magnitudes
from test_torch_kernels import encoder_case

torch.set_num_threads(2)
SPEC = mix_spec(GSConfig())


def sequential_sum(t: torch.Tensor) -> torch.Tensor:
    """The CPU's sum of F contiguous floats: in order from the first."""
    cols = t.unbind(-1)
    total = cols[0]
    for c in cols[1:]:
        total = total + c
    return total


def eager_backward(params: dict, x: np.ndarray, g: np.ndarray):
    """Autograd through the eager encoder: (the rows and indices it hands
    grid_scatter, by encoder; the gradient to x; the raw tables'
    gradients, in MIX_ENCODERS order)."""
    xr = torch.from_numpy(x).requires_grad_(True)
    ps = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in params.items()}
    calls, original = [], th.grid_scatter

    def record(rows, idx, n_cells):
        calls.append((rows.clone(), idx.clone()))
        return original(rows, idx, n_cells)

    th.grid_scatter = record
    try:
        out = th.mix_encode(ps, xr, SPEC)
        dx, *dt = torch.autograd.grad(
            out, [xr] + [ps[k] for k in th.MIX_ENCODERS],
            torch.from_numpy(g))
    finally:
        th.grid_scatter = original
    # autograd reaches the encoders' gathers last to first
    return dict(zip(reversed(th.MIX_ENCODERS), calls)), dx, dt


def twin(params: dict, x: np.ndarray, g: np.ndarray):
    tables = th.mix_tables({k: torch.from_numpy(v)
                            for k, v in params.items()}, SPEC)
    return th.mix_encode_backward_plain(tables, torch.from_numpy(x),
                                        torch.from_numpy(g), SPEC)


@pytest.fixture(scope='module')
def case():
    x, params, g = encoder_case(SPEC)
    return x, params, g, eager_backward(params, x, g)


def test_mix_encode_bitwise_jax(case):
    """The port's mix_encode (its plain version on the CPU, and
    ``_MixEncode`` over the binarized tables) bitwise JAX's at the default
    widths: dense and hashed levels, the boundary ring, x exactly 0 and 1,
    rows outside the unit cube."""
    x, params, _, _ = case
    js = jax_mix_spec(JaxConfig())
    want = np.asarray(jh.mix_encode(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x), js))
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    got = th.mix_encode(tp, torch.from_numpy(x), SPEC)
    np.testing.assert_array_equal(got.numpy(), want)
    fused = th._MixEncode.apply(SPEC, torch.from_numpy(x),
                                *th.mix_tables(tp, SPEC))
    np.testing.assert_array_equal(fused.numpy(), want)
    assert np.any(want[~np.all((x >= 0) & (x <= 1), -1)] == 0)


def test_backward_rows_bitwise_autograd(case):
    """The twin's corner rows and table indices bitwise autograd's, in its
    layout (levels, corners, rows); the raw tables' gradients through
    ``_MixEncode`` (the rows, grid_scatter, the sign's straight-through
    rule) bitwise autograd's through the eager code."""
    x, params, g, (eager_rows, _, eager_dt) = case
    rows, idx, _ = twin(params, x, g)
    for e, name in enumerate(th.MIX_ENCODERS):
        assert torch.equal(rows[e], eager_rows[name][0]), name
        assert torch.equal(idx[e], eager_rows[name][1]), name
    xr = torch.from_numpy(x).requires_grad_(True)
    ps = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in params.items()}
    out = th._MixEncode.apply(SPEC, xr, *th.mix_tables(ps, SPEC))
    dt = torch.autograd.grad(out, [ps[k] for k in th.MIX_ENCODERS],
                             torch.from_numpy(g))
    for a, b, name in zip(dt, eager_dt, th.MIX_ENCODERS):
        assert torch.equal(a, b), name
        assert bool((a != 0).any()), name


def test_dx_matches_autograd(case, monkeypatch):
    """The twin's gradient to x (and ``_MixEncode``'s, the same bits)
    within HASHGRID_DX_RTOL of the summed magnitudes of its terms of
    autograd's, exactly 0 where every encoder's input lies outside the
    unit cube; with the CPU's feature sum patched in, bitwise autograd's."""
    x, params, g, (_, eager_dx, _) = case
    _, _, dx = twin(params, x, g)
    tables = th.mix_tables({k: torch.from_numpy(v)
                            for k, v in params.items()}, SPEC)
    mag = hashgrid_dx_magnitudes(tables, torch.from_numpy(x),
                                 torch.from_numpy(g), SPEC)
    err = (dx.double() - eager_dx.double()).abs()
    assert bool((err <= HASHGRID_DX_RTOL * mag).all())
    assert bool((mag > 0).all(-1)[np.all((x >= 0) & (x <= 1), -1)].all())
    outside = ~np.any([np.all((x[:, c] >= 0) & (x[:, c] <= 1), -1)
                       for c in ([0, 1, 2], [0, 1], [0, 2], [1, 2])], 0)
    assert outside.any() and not dx[outside].any()
    xr = torch.from_numpy(x).requires_grad_(True)
    out = th._MixEncode.apply(SPEC, xr, *tables)
    (fused_dx,) = torch.autograd.grad(out, [xr], torch.from_numpy(g))
    assert torch.equal(fused_dx, dx)
    monkeypatch.setattr(th, '_feature_sum', sequential_sum)
    _, _, dx_cpu_order = twin(params, x, g)
    assert torch.equal(dx_cpu_order, eager_dx)


def test_planted_fault_fails(case, monkeypatch):
    """The twin with one corner's weight left out of the normalizer wn
    fails the row and the gradient checks."""
    x, params, g, (eager_rows, eager_dx, _) = case
    src = inspect.getsource(th.grid_encode_backward_plain)
    line = '            wn = wn + wv\n'
    assert src.count(line) == 1
    scope = dict(vars(th))
    exec(src.replace(line, '            wn = wn + wv * (corner != 1)\n'),
         scope)
    monkeypatch.setattr(th, 'grid_encode_backward_plain',
                        scope['grid_encode_backward_plain'])
    rows, _, dx = twin(params, x, g)
    assert not torch.equal(rows[0], eager_rows['xyz'][0])
    tables = th.mix_tables({k: torch.from_numpy(v)
                            for k, v in params.items()}, SPEC)
    mag = hashgrid_dx_magnitudes(tables, torch.from_numpy(x),
                                 torch.from_numpy(g), SPEC)
    err = (dx.double() - eager_dx.double()).abs()
    assert not bool((err <= HASHGRID_DX_RTOL * mag).all())
