"""Port parity: the train-mode decode in phases 1 and 2, dense and
compacted, and the SH-color and feature-bank branches, against the JAX
package with JAX's own random draws carried across as a ``DecodeNoise``.

Each case decodes a small model (300 points, feat_dim 16, 4 offsets, two
3D hash levels and one 2D level) once in each package and takes the
gradient of one scalar: a seeded weighted sum of every float output (xyz,
color, opacity, scaling, rotation, neural opacity) and of the four rate
fields. Compacted cases gather the visible anchors into a bucket with
padding rows, the quantization means taken over the full state, and the
gradient goes back through the gather. Phase 1 runs dense and compacted,
phase 2 compacted (its dense decode is held by the phase-2 training step
in tests/test_torch_train.py); the SH color (degrees 2 and 3) and the
feature bank run in both phases.

JAX runs op by op, the arithmetic the port reproduces: under ``jax.jit``
XLA contracts multiply-adds in the hash grid and the entropy, and the
rate's gradients then move by up to 5% of a leaf's largest.

- The outputs within 1e-5 absolute and relative: the heads' products sum
  in another order in torch than in XLA (see tests/test_torch_decode.py).
  The validity masks are equal. The four rate fields within 1e-4
  relative: the entropy's CDF rounds differently in the last bit
  (tests/test_torch_entropy.py).
- Every trained leaf's gradient (the anchor leaves, each head, the four
  hash tables) within 1e-4 of the leaf's largest gradient plus 1e-3
  relative: the scalar sums ~10K products, and the hash tables' gradients
  are sums over anchors taken in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bloomscene_tpu.config import GSConfig as JaxConfig
from bloomscene_tpu.models.anchors import get_scaling, update_anchor_bounds
from bloomscene_tpu.models.decode import _masked_mean
from bloomscene_tpu.models.decode import decode_neural_gaussians as jax_decode
from bloomscene_tpu.models.model import init_model as jax_init_model
from bloomscene_tpu_torch.config import GSConfig
from bloomscene_tpu_torch.convert import leaf_key, model_from_jax_params
from bloomscene_tpu_torch.models.decode import (DecodeNoise, attribute_means,
                                                decode_neural_gaussians)
from bloomscene_tpu_torch.models.render import compact_visible
from bloomscene_tpu_torch.train.optim import make_trainable, param_groups

torch.set_num_threads(2)
NARROW = dict(feat_dim=16, n_offsets=4, resolutions_3d=(18, 33),
              log2_hashmap_size_3d=10, resolutions_2d=(130,),
              log2_hashmap_size_2d=10, voxel_size=0.08)
TRAINED = ('anchor', 'offset', 'mask_logit', 'feat', 'scaling_log')
CASES = {
    'phase1': (1, False, {}),
    'phase2-compacted': (2, True, {}),
    'phase2-compacted-sh2-bank': (2, True, {'color_mode': 'sh',
                                            'sh_degree': 2,
                                            'use_feat_bank': True}),
    'phase1-compacted-sh3-bank': (1, True, {'color_mode': 'sh',
                                            'sh_degree': 3,
                                            'use_feat_bank': True}),
}


def jax_noise(key, phase, rows, F, K):
    """The draws JAX's decode takes from ``key`` (decode.py:101-117)."""
    if phase == 1:
        k1, k2, k3 = jax.random.split(key, 3)
        u = None
    else:
        k1, k2, k3, k4 = jax.random.split(key, 4)
        u = np.array(jax.random.uniform(k4, (rows,)))
    return DecodeNoise(
        *(torch.from_numpy(np.array(jax.random.normal(k, shape)))
          for k, shape in ((k1, (rows, F)), (k2, (rows, 6)),
                           (k3, (rows, K, 3)))),
        choose=None if u is None else torch.from_numpy(u))


def loss_weights(rng, C, K):
    n = C * K
    return {'xyz': rng.normal(size=(n, 3)), 'color': rng.normal(size=(n, 3)),
            'opacity': rng.normal(size=n), 'scaling': rng.normal(size=(n, 3)),
            'rotation': rng.normal(size=(n, 4)),
            'neural_opacity': rng.normal(size=n),
            'rate': rng.normal(size=4) * 0.1}


def scalar(dec, rate, w, lib):
    total = sum(lib.sum(getattr(dec, f) * w[f]) for f in
                ('xyz', 'color', 'opacity', 'scaling', 'rotation',
                 'neural_opacity'))
    return total + sum(r * c for r, c in zip(rate[:4], w['rate']))


@pytest.mark.parametrize('case', list(CASES))
def test_decode_phase_matches_jax(case):
    phase, compacted, extra = CASES[case]
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    pts[:, 2] += 2.5
    jcfg, tcfg = JaxConfig(**NARROW, **extra), GSConfig(**NARROW, **extra)
    m, _ = jax_init_model(jax.random.PRNGKey(0), pts, jcfg, capacity=384)
    st = m.state
    C, F, K = st.capacity, jcfg.feat_dim, jcfg.n_offsets
    alive = np.asarray(st.alive)
    mask_logit = rng.normal(0.5, 3, (C, K, 1)).astype(np.float32)
    st = st._replace(
        feat=jnp.asarray(rng.normal(0, 1, (C, F)).astype(np.float32)),
        offset=jnp.asarray(rng.normal(0, 0.5, (C, K, 3)).astype(np.float32)),
        mask_logit=jnp.asarray(mask_logit))
    m = m._replace(state=st, bounds=update_anchor_bounds(st))
    visible = alive & (rng.uniform(size=C) < 0.7)
    vcap = int(visible.sum()) + 5 if compacted else None
    rows = vcap or C
    cam = np.array([0.1, -0.2, 0.3], np.float32)
    key = jax.random.PRNGKey(7)
    w = loss_weights(rng, rows, K)

    def jax_fn(leaves):
        state = st._replace(**leaves['state'])
        model = m._replace(state=state, heads=leaves['heads'],
                           grid=leaves['grid'])
        vis, means = jnp.asarray(visible), None
        if compacted:
            aw = state.alive.astype(jnp.float32)
            means = (_masked_mean(state.feat, aw[:, None]),
                     _masked_mean(get_scaling(state), aw[:, None]),
                     _masked_mean(state.offset, aw[:, None, None]))
            idx = jnp.nonzero(vis, size=vcap, fill_value=C)[0]
            ok = idx < C
            safe = jnp.minimum(idx, C - 1)
            model = model._replace(state=state.gather_rows(
                safe, ok & state.alive[safe]))
            vis = None
        dec, rate = jax_decode(model, jnp.asarray(cam), jcfg, phase=phase,
                               mode='train', visible=vis, key=key,
                               attr_means=means)
        return scalar(dec, rate, w, jnp), (dec, rate)

    leaves = {'state': {f: getattr(st, '_' + f) for f in TRAINED},
              'heads': m.heads, 'grid': m.grid}
    (_, (dj, rj)), gj = jax.value_and_grad(jax_fn, has_aux=True)(leaves)

    tm = make_trainable(model_from_jax_params(jax.tree.map(np.asarray, m),
                                              tcfg, device='cpu'))
    noise = jax_noise(key, phase, rows, F, K)
    with torch.enable_grad():
        model, vis, means = tm, torch.from_numpy(visible), None
        if compacted:
            means = attribute_means(tm.state)
            model, _ = compact_visible(tm, vis, vcap)
            vis = None
        dt, rt = decode_neural_gaussians(model, torch.from_numpy(cam), tcfg,
                                         phase=phase, mode='train',
                                         visible=vis, noise=noise,
                                         attr_means=means)
        wt = {k: torch.from_numpy(v.astype(np.float32)) for k, v in w.items()}
        params = param_groups(tm)
        gt = torch.autograd.grad(scalar(dt, rt, wt, torch),
                                 [p for _, _, p in params],
                                 materialize_grads=True)

    np.testing.assert_array_equal(dt.valid.numpy(), np.asarray(dj.valid))
    for f in dt._fields:
        if f != 'valid':
            np.testing.assert_allclose(getattr(dt, f).detach().numpy(),
                                       np.asarray(getattr(dj, f)),
                                       atol=1e-5, rtol=1e-5, err_msg=f)
    for f, a, b in zip(rt._fields, rt, rj):
        np.testing.assert_allclose(float(a.detach()), float(b), rtol=1e-4,
                                   err_msg=f)
    if phase == 2:
        assert float(rj.bit_per_param) > 0

    def jax_grad(key):
        if key[0] == 'state':
            return np.asarray(gj['state'][key[1]])
        if key[0] == 'heads':
            return np.asarray(gj['heads'][key[1]][key[2]][key[3]])
        return np.asarray(gj['grid'][key[1]])

    for (name, _, p), g in zip(params, gt):
        key, transposed = leaf_key(name)
        want = jax_grad(key)
        got = g.numpy().T if transposed else g.numpy().reshape(-1)
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4 * scale,
                                   err_msg=f"{case}: gradient {name}")
    grids_reached = [float(np.abs(jax_grad(('grid', k))).max()) > 0
                     for k in ('xyz', 'xy', 'xz', 'yz')]
    assert all(grids_reached) == (phase == 2), grids_reached
