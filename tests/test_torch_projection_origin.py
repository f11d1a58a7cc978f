"""The projection at the camera's center: a row at or below the near plane
takes a safe depth before the EWA Jacobian (``ops/projection.py``).

Without it a row within ~1e-7 of the center overflows the Jacobian's
1/z, and its cotangent, zero by the ``valid`` mask, meets the inf as 0 *
inf = NaN: the step's gradients are NaN and its update is skipped. The
compaction pads the decode's bucket with the last slot, empty, its anchor
at the origin, where an orbit of ``cameras/rotate360.json`` puts every
camera. The valid rows keep the JAX package's bits (it has the same fault
at the culled rows, so only the valid rows are compared with it).
"""
import math

import jax.numpy as jnp
import numpy as np
import torch

from bloomscene_tpu.ops import projection as jp
from bloomscene_tpu_torch.ops import graphics as tg
from bloomscene_tpu_torch.ops import projection as tp

W, H, FOV = 64, 64, 1.0


def camera():
    view = tg.world_to_view(np.eye(3), np.zeros(3))
    full = tg.projection_matrix(0.01, 100.0, FOV, FOV) @ view
    return (view, full, tg.fov2focal(FOV, W), tg.fov2focal(FOV, H),
            np.tan(FOV / 2), np.tan(FOV / 2))


def rows(rng, n):
    """Rows in front of the near plane, behind it, at it and within 1e-7 of
    the camera's center (view z of 0 and +-1e-8 among them)."""
    z = np.concatenate([rng.uniform(0.25, 6, n), rng.uniform(-1, 0.2, n),
                        [0.2, 0.0, 1e-8, -1e-8, 1e-7]])
    m = len(z)
    means = np.stack([rng.uniform(-2, 2, m) * np.abs(z),
                      rng.uniform(-2, 2, m) * np.abs(z), z],
                     -1).astype(np.float32)
    means[-5:, :2] = [[0.0, 0.0], [0.0, 0.0], [1e-9, 0.0], [0.0, -1e-9],
                      [3e-8, 2e-8]]
    scales = rng.uniform(0.01, 0.5, (m, 3)).astype(np.float32)
    quats = rng.normal(size=(m, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    return means, scales, quats


def test_valid_rows_keep_the_jax_bits(rng):
    means, scales, quats = rows(rng, 300)
    view, full, fx, fy, tx, ty = camera()
    pj = jp.project_gaussians(
        jnp.asarray(means), jp.build_cov3d(jnp.asarray(scales),
                                           jnp.asarray(quats)),
        jnp.asarray(view), jnp.asarray(full), W, H, fx, fy, tx, ty)
    pt = tp.project_gaussians(
        torch.from_numpy(means), tp.build_cov3d(torch.from_numpy(scales),
                                                torch.from_numpy(quats)),
        torch.from_numpy(view), torch.from_numpy(full), W, H, fx, fy, tx, ty)
    valid = pt.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(pj.valid))
    assert 0 < valid.sum() < 300 and not valid[300:].any()
    for name, a, b in zip(pj._fields, pj, pt):
        np.testing.assert_array_equal(np.asarray(a)[valid], b.numpy()[valid],
                                      err_msg=name)
    assert np.all(np.isfinite(pt.conic.numpy()))


def test_rows_at_the_center_give_finite_gradients(rng):
    """The gradient of a loss over the valid rows: finite everywhere, and
    exactly zero at every culled row."""
    means, scales, quats = rows(rng, 50)
    view, full, fx, fy, tx, ty = camera()
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (means, scales, quats)]
    p = tp.project_gaussians(leaves[0], tp.build_cov3d(*leaves[1:]),
                             torch.from_numpy(view), torch.from_numpy(full),
                             W, H, fx, fy, tx, ty)
    w = torch.from_numpy(rng.normal(size=(len(means), 6)).astype(np.float32))
    terms = ((w[:, :2] * p.mean2d * 0.01).sum(-1)
             + (w[:, 2:5] * p.conic).sum(-1) + w[:, 5] * p.depth)
    grads = torch.autograd.grad(torch.where(p.valid, terms, 0.0).sum(),
                                leaves)
    culled = ~p.valid
    assert culled[-5:].all() and p.valid.any()
    for g in grads:
        assert torch.isfinite(g).all()
        assert (g[culled] == 0).all()
        assert (g[p.valid] != 0).any()


def test_phase2_step_with_padding_at_the_camera_center():
    """A tiny phase-2 step of ``room111k``'s files (64x64, ~5.5K anchors in
    8,192 slots, a bucket of 4,096 rows, the ``rotate360`` orbit) through
    the device loop: the bucket is padded with the last, empty slot, and
    each camera sits at that slot's quantized anchor (within one
    quantization cell of the origin). The empty slots' offset scale is
    e^-30, so their children sit within ~1e-12 of it: the view z that
    overflowed 1/z. Every update is taken, and every gradient is
    finite."""
    from perfbench import harness
    from perfbench.tests.tiny import TINY_SEED, tiny_files

    from bloomscene_tpu_torch.models.anchors import get_anchor_quantized
    from bloomscene_tpu_torch.scene.cameras import CameraArrays
    torch.set_num_threads(2)
    files = tiny_files("room111k.train_p0")
    config = files["config"]
    traffic = dict(files["traffic"], start_step=2000, phase=2,
                   track_stats=False, gsconfig={})
    inputs = harness.make_inputs(config, traffic, TINY_SEED, "cpu")
    w = inputs["weights"]
    n, C = inputs["n_anchors"], w["state.alive"].numel()
    assert n < C
    w["state.scaling_log"].view(C, 6)[n:, :3] = -30.0
    trainer = harness.build_trainer(config, traffic, inputs, TINY_SEED,
                                    "cpu")
    st = trainer.model.state
    center = get_anchor_quantized(st, trainer.model.bounds)[C - 1].detach()
    assert not st.alive[C - 1] and center.abs().max() < 1e-3
    cams = inputs["cams"]
    for i in range(len(cams["viewmat"])):
        v = torch.as_tensor(cams["viewmat"][i]).double()
        v[:3, 3] = -(v[:3, :3] @ center.double())
        full = torch.as_tensor(cams["full_proj"][i]).double() @ torch.linalg.inv(
            torch.as_tensor(cams["viewmat"][i]).double()) @ v
        cams["viewmat"][i] = v.float().numpy()
        cams["full_proj"][i] = full.float().numpy()
        cams["center"][i] = center.numpy()
    views = harness.views_for(CameraArrays, inputs, "cpu")
    trainer.run(views, iterations=2003, log_every=1, device_loop=True,
                max_chunk=4)
    recs = trainer.history
    assert [r["iteration"] for r in recs] == [2001, 2002, 2003]
    assert all(r["skipped"] == 0 and math.isfinite(r["loss"])
               for r in recs)
    assert all(0 < r["n_visible_anchors"] < 4096 for r in recs)
    for m in trainer.optimizer.m:
        assert torch.isfinite(m).all()
    assert any(m.abs().max() > 0 for m in trainer.optimizer.m)


def test_ewa_cov2d_takes_the_near_plane(rng):
    """``ewa_cov2d`` and ``project_gaussians`` agree on the rows the near
    plane keeps and repair the same ones."""
    means, scales, quats = rows(rng, 40)
    view, full, fx, fy, tx, ty = camera()
    cov6 = tp.build_cov3d(torch.from_numpy(scales), torch.from_numpy(quats))
    m = torch.from_numpy(means)
    cov2 = tp.ewa_cov2d(m, cov6, torch.from_numpy(view), fx, fy, tx, ty)
    p = tp.project_gaussians(m, cov6, torch.from_numpy(view),
                             torch.from_numpy(full), W, H, fx, fy, tx, ty)
    assert torch.isfinite(cov2).all()
    a, b, c = cov2.unbind(-1)
    inv_det = 1.0 / (a * c - b * b)
    front = p.depth > tp.NEAR
    assert front.any() and not front.all()
    torch.testing.assert_close(
        p.conic[front], torch.stack([c * inv_det, -b * inv_det,
                                     a * inv_det], -1)[front],
        rtol=0, atol=0)
