"""Port parity: camera math and projection (bloomscene_tpu_torch.ops) against
the JAX package on the same inputs.

Projection is elementwise float32 arithmetic in the same order in both
packages, so the outputs are asserted bitwise equal, the conic at the
rows in front of the near plane: the port gives a row at or below it a
safe depth before the EWA Jacobian (its conic is finite there, where the
JAX package divides by the depth; the row is culled in both).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from bloomscene_tpu.ops import graphics as jg
from bloomscene_tpu.ops import projection as jp
from bloomscene_tpu_torch.ops import graphics as tg
from bloomscene_tpu_torch.ops import projection as tp

torch.set_num_threads(2)


def make_camera(W=64, H=64, fovx=1.0, fovy=1.0):
    view = tg.world_to_view(np.eye(3), np.zeros(3))
    full = tg.projection_matrix(0.01, 100.0, fovx, fovy) @ view
    return (view, full, tg.fov2focal(fovx, W), tg.fov2focal(fovy, H),
            np.tan(fovx / 2), np.tan(fovy / 2))


def assert_same_projection(pj, pt):
    """Every output bitwise, the conic at the rows in front of the near
    plane (every valid row is one); the port's conic finite behind it."""
    front = pt.depth.numpy() > tp.NEAR
    for name, a, b in zip(pj._fields, pj, pt):
        a, b = np.asarray(a), b.numpy()
        if name == 'conic':
            np.testing.assert_array_equal(a[front], b[front], err_msg=name)
            assert np.all(np.isfinite(b[~front]))
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def both_project(means, scales, quats, W=64, H=64):
    view, full, fx, fy, tx, ty = make_camera(W, H)
    pj = jp.project_gaussians(
        jnp.asarray(means), jp.build_cov3d(jnp.asarray(scales),
                                           jnp.asarray(quats)),
        jnp.asarray(view), jnp.asarray(full), W, H, fx, fy, tx, ty)
    pt = tp.project_gaussians(
        torch.from_numpy(means), tp.build_cov3d(torch.from_numpy(scales),
                                                torch.from_numpy(quats)),
        torch.from_numpy(view), torch.from_numpy(full), W, H, fx, fy, tx, ty)
    return pj, pt


def test_camera_matrices_match():
    R = np.linalg.qr(np.random.default_rng(3).normal(size=(3, 3)))[0]
    t = np.array([0.3, -0.2, 1.5])
    for kw in ({}, {'translate': np.array([0.1, 0.2, 0.3]), 'scale': 1.7}):
        np.testing.assert_array_equal(tg.world_to_view(R, t, **kw),
                                      jg.world_to_view(R, t, **kw))
    np.testing.assert_array_equal(tg.projection_matrix(0.01, 100.0, 0.8, 0.7),
                                  jg.projection_matrix(0.01, 100.0, 0.8, 0.7))
    assert tg.fov2focal(0.9, 512) == jg.fov2focal(0.9, 512)
    assert tg.focal2fov(582.69, 512) == jg.focal2fov(582.69, 512)


def test_quat_identity_and_90deg_z():
    s = np.sqrt(0.5)
    for q, want in (([1.0, 0, 0, 0], np.eye(3)),
                    ([s, 0.0, 0.0, s],
                     np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]]))):
        R = tg.quat_to_rotmat(torch.tensor(q, dtype=torch.float32)).numpy()
        np.testing.assert_allclose(R, want, atol=1e-6)
        np.testing.assert_array_equal(
            R, np.asarray(jg.quat_to_rotmat(jnp.asarray(q, jnp.float32))))


def test_cov3d_cases(rng):
    cov = tp.build_cov3d(torch.tensor([[0.5, 0.5, 0.5]]),
                         torch.tensor([[1.0, 0, 0, 0]]))
    np.testing.assert_allclose(cov[0], [0.25, 0, 0, 0.25, 0, 0.25],
                               atol=1e-6)
    cov = tp.build_cov3d(torch.tensor([[1.0, 2.0, 3.0]]),
                         torch.tensor([[1.0, 0, 0, 0]]))
    np.testing.assert_allclose(cov[0], [1, 0, 0, 4, 0, 9], atol=1e-5)
    # isotropic covariance is rotation invariant; random ones match JAX
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    iso = tp.build_cov3d(torch.full((64, 3), 0.3), torch.from_numpy(q))
    np.testing.assert_allclose(iso, np.tile([0.09, 0, 0, 0.09, 0, 0.09],
                                            (64, 1)), atol=1e-3)
    s = rng.uniform(0.01, 0.5, (64, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tp.build_cov3d(torch.from_numpy(s), torch.from_numpy(q)).numpy(),
        np.asarray(jp.build_cov3d(jnp.asarray(s), jnp.asarray(q))))


def test_project_center_near_and_offscreen():
    means = np.array([[0.0, 0.0, 2.0], [0.0, 0.0, 0.1], [0.0, 0.0, -1.0],
                      [100.0, 0.0, 2.0]], np.float32)
    scales = np.full((4, 3), 0.1, np.float32)
    scales[3] = 0.01
    quats = np.tile(np.array([1.0, 0, 0, 0], np.float32), (4, 1))
    pj, pt = both_project(means, scales, quats)
    assert pt.valid.tolist() == [True, False, False, False]
    np.testing.assert_allclose(pt.mean2d[0], [31.5, 31.5], atol=1e-4)
    np.testing.assert_allclose(pt.depth[0], 2.0, atol=1e-5)
    assert int(pt.radius[0]) > 0
    assert_same_projection(pj, pt)


def test_projection_bitwise_random(rng):
    n = 400
    means = np.stack([rng.uniform(-3, 3, n), rng.uniform(-3, 3, n),
                      rng.uniform(-1, 6, n)], -1).astype(np.float32)
    scales = rng.uniform(0.005, 0.6, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    pj, pt = both_project(means, scales, quats, W=96, H=72)
    assert 0 < int(pt.valid.sum()) < n
    assert_same_projection(pj, pt)
    view, _, fx, fy, tx, ty = make_camera(96, 72)
    cov6 = tp.build_cov3d(torch.from_numpy(scales), torch.from_numpy(quats))
    front = pt.depth.numpy() > tp.NEAR
    np.testing.assert_array_equal(
        tp.ewa_cov2d(torch.from_numpy(means), cov6, torch.from_numpy(view),
                     fx, fy, tx, ty).numpy()[front],
        np.asarray(jp.ewa_cov2d(jnp.asarray(means), jnp.asarray(cov6.numpy()),
                                jnp.asarray(view), fx, fy, tx, ty))[front])


def test_projection_differentiable():
    view, full, fx, fy, tx, ty = make_camera()
    means = torch.tensor([[0.1, -0.2, 2.0]], requires_grad=True)
    cov6 = tp.build_cov3d(torch.full((1, 3), 0.1),
                          torch.tensor([[1.0, 0, 0, 0]]))
    out = tp.project_gaussians(means, cov6, torch.from_numpy(view),
                               torch.from_numpy(full), 64, 64, fx, fy, tx, ty)
    (out.mean2d.sum() + out.depth.sum()).backward()
    g = means.grad.numpy()
    assert np.all(np.isfinite(g)) and np.abs(g).sum() > 0


def test_projection_grads_match_jax(rng):
    """The gradients of ``build_cov3d`` + ``project_gaussians`` with respect
    to means, scales and quaternions against ``jax.grad``, for a loss over
    the valid splats' mean2d, conic and depth. Tolerance atol 1e-6 + rtol
    1e-3: the forwards are bitwise equal, but the two autodiff systems
    order the adjoint's products and sums differently, and the conic's
    adjoint goes through the 2D covariance's determinant, which cancels
    for thin splats (measured: 1.4e-4 relative at worst on this input)."""
    n = 200
    means = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                      rng.uniform(0.5, 6, n)], -1).astype(np.float32)
    scales = rng.uniform(0.01, 0.4, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    w = rng.normal(size=(n, 6)).astype(np.float32)
    view, full, fx, fy, tx, ty = make_camera(96, 72)

    def loss(lib, proj_mod, m, s, q, wt, v, f):
        p = proj_mod.project_gaussians(m, proj_mod.build_cov3d(s, q), v, f,
                                       96, 72, fx, fy, tx, ty)
        terms = ((wt[:, 0:2] * p.mean2d * 0.01).sum(-1)
                 + (wt[:, 2:5] * p.conic * 100.0).sum(-1) + wt[:, 5] * p.depth)
        return lib.where(p.valid, terms, 0.0).sum()

    gj = jax.grad(lambda m, s, q: loss(jnp, jp, m, s, q, jnp.asarray(w),
                                       jnp.asarray(view), jnp.asarray(full)),
                  argnums=(0, 1, 2))(jnp.asarray(means), jnp.asarray(scales),
                                     jnp.asarray(quats))
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (means, scales, quats)]
    gt = torch.autograd.grad(
        loss(torch, tp, *leaves, torch.from_numpy(w), torch.from_numpy(view),
             torch.from_numpy(full)), leaves)
    for name, a, b in zip(('means', 'scales', 'quats'), gt, gj):
        b = np.asarray(b)
        assert np.abs(b).max() > 0
        np.testing.assert_allclose(a.numpy(), b, atol=1e-6, rtol=1e-3,
                                   err_msg=name)
