"""Port parity: the entropy models and the SH color against the JAX
package, on seeded numpy inputs.

- ``entropy_gaussian_bits``: values within 1e-4 relative + 1e-5 absolute
  bits, gradients (to x, mean, scale, q and x_mean) within 1e-3 relative
  + 1e-4 absolute of the largest entry. Both packages form the CDF from
  ``erf``/``erfc`` in JAX's arrangement, but torch and XLA round those in
  the last bit, and ``upper - lower`` magnifies that where the interval
  sits in a tail. The cases cover the clamp to x_mean +- 15000 q, a scale
  under the 1e-9 floor, and the region where the likelihood falls under
  the 1e-6 low bound (only gradients that raise the likelihood pass;
  where both CDFs round to 1, the gradient passes through |d| at d = 0 as
  JAX's ``abs`` lets it). The low bound's rule switches at 1e-6: entries
  whose likelihood lies within 1e-3 of it (at most 2% of a case) may take
  either side and are left out of the gradient comparison.
- ``binary_entropy_bits``: 1e-6 relative.
- ``eval_sh``, degrees 0-3: values and gradients (to the coefficients and
  the means) within 1e-5 relative + 1e-6 absolute (the einsum and the
  norm sum in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bloomscene_tpu.ops import entropy as je
from bloomscene_tpu.ops import sh as jsh
from bloomscene_tpu_torch.ops import entropy as te
from bloomscene_tpu_torch.ops import sh as tsh

torch.set_num_threads(2)


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def entropy_case(rng, name):
    n = 400
    x = rng.normal(0, 1, n).astype(np.float32)
    mean = rng.normal(0, 0.5, n).astype(np.float32)
    scale = rng.uniform(0.05, 2, n).astype(np.float32)
    q = rng.uniform(0.01, 0.3, n).astype(np.float32)
    x_mean = np.float32(0.1)
    if name == 'clamp':
        # a third of x outside x_mean +- 15000 q
        x[: n // 3] = np.sign(rng.normal(size=n // 3)) * (
            15000 * q[: n // 3] * rng.uniform(1.01, 3, n // 3))
    elif name == 'tiny_scale':
        scale[: n // 2] = rng.uniform(0, 1e-9, n // 2)
        mean[: n // 2] = x[: n // 2] + rng.uniform(-1e-3, 1e-3, n // 2)
    elif name == 'low_bound':
        # far tails: the likelihood falls under 1e-6 for about half
        scale[:] = rng.uniform(0.01, 0.05, n)
        x = mean + rng.normal(0, 0.3, n).astype(np.float32)
    return x, mean, scale, q, x_mean


def raw_likelihood(x, mean, scale, q, x_mean):
    """The JAX package's likelihood before its low bound."""
    x = np.clip(x, x_mean - 15000 * q, x_mean + 15000 * q)
    scale = np.maximum(scale, 1e-9)
    cdf = [np.asarray(je.gaussian_cdf(jnp.asarray(x + s * 0.5 * q),
                                      jnp.asarray(mean), jnp.asarray(scale)))
           for s in (1, -1)]
    return np.abs(cdf[0] - cdf[1])


@pytest.mark.parametrize('name', ['plain', 'clamp', 'tiny_scale',
                                  'low_bound'])
def test_entropy_gaussian_bits_matches_jax(rng, name):
    args = entropy_case(rng, name)
    g = rng.normal(size=args[0].shape).astype(np.float32)
    out_j, vjp = jax.vjp(je.entropy_gaussian_bits,
                         *(jnp.asarray(a) for a in args))
    grads_j = vjp(jnp.asarray(g))
    ts = [t(a).requires_grad_(True) for a in args]
    out_t = te.entropy_gaussian_bits(*ts)
    grads_t = torch.autograd.grad(out_t, ts, t(g))
    out_j = np.asarray(out_j)
    if name == 'low_bound':
        floor = -np.log2(np.float32(1e-6))
        share = float(np.mean(out_j >= floor - 1e-3))
        assert 0.2 < share < 0.8, share
    np.testing.assert_allclose(out_t.detach().numpy(), out_j, rtol=1e-4,
                               atol=1e-5)
    # the low bound's gradient rule switches at likelihood == 1e-6: where
    # the likelihood lies within 1e-3 of it, a last-bit difference may
    # take either side (rare; the rest holds the tolerance)
    at_bound = np.abs(raw_likelihood(*args) / 1e-6 - 1.0) < 1e-3
    assert at_bound.mean() <= 0.02, at_bound.mean()
    for k, (a, b) in enumerate(zip(grads_t, grads_j)):
        a, b = a.numpy(), np.asarray(b)
        if a.ndim:
            a, b = a[~at_bound], b[~at_bound]
        np.testing.assert_allclose(a, b, rtol=1e-3,
                                   atol=1e-4 * max(np.abs(b).max(), 1e-30),
                                   err_msg=f"{name}: argument {k}")


def test_binary_entropy_bits_matches_jax(rng):
    for p_one in (0.0, 0.3, 1.0):
        x = np.where(rng.uniform(size=(64, 7)) < p_one, 1.0, -1.0).astype(
            np.float32)
        pj, bj = je.binary_entropy_bits(jnp.asarray(x))
        pt, bt = te.binary_entropy_bits(t(x))
        np.testing.assert_allclose(float(pt), float(pj), rtol=1e-6)
        np.testing.assert_allclose(float(bt), float(bj), rtol=1e-6)


@pytest.mark.parametrize('degree', [0, 1, 2, 3])
def test_eval_sh_matches_jax(rng, degree):
    n, m = 300, 16
    coeffs = rng.normal(0, 1.5, (n, m, 3)).astype(np.float32)
    means = rng.normal(0, 2, (n, 3)).astype(np.float32)
    campos = np.array([0.3, -0.2, -4.0], np.float32)
    g = rng.normal(size=(n, 3)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda c, p: jsh.eval_sh(degree, c, p,
                                                  jnp.asarray(campos)),
                         jnp.asarray(coeffs), jnp.asarray(means))
    gc_j, gm_j = vjp(jnp.asarray(g))
    c_t, m_t = t(coeffs).requires_grad_(True), t(means).requires_grad_(True)
    out_t = tsh.eval_sh(degree, c_t, m_t, t(campos))
    gc_t, gm_t = torch.autograd.grad(out_t, (c_t, m_t), t(g),
                                     materialize_grads=True)
    assert (np.asarray(out_j) == 0).any()          # some channels clamp
    for a, b in ((out_t.detach(), out_j), (gc_t, gc_j), (gm_t, gm_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    with pytest.raises(ValueError):
        tsh.sh_basis(4, t(means))
