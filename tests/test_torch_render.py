"""Port parity for the whole slice: decode -> projection -> binning -> blend.

The port's ``render`` against the JAX package's ``render`` (eval mode,
visible-anchor compaction, backend 'pallas' with the Pallas kernels in
interpret mode) on a narrow configuration: feat_dim 16, 4 offsets, three
3D and one 2D hash level at 2^10, ~1400 anchors, 64x64. Color and alpha
within 1e-4 absolute, depth within 1e-3 relative: the heads' matrix
products round differently in torch and XLA (which, under ``jax.jit``, also
fuses multiply-adds), and the differences pass through projection and the
blend.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bloomscene_tpu.config import GSConfig as JaxConfig
from bloomscene_tpu.models import anchors as jax_anchors
from bloomscene_tpu.models.render import prefilter_anchors as jax_prefilter
from bloomscene_tpu.models.render import render as jax_render
from bloomscene_tpu.ops.pallas import blend as pallas_blend
from bloomscene_tpu.scene.cameras import camera_from_rt as jax_camera
from bloomscene_tpu_torch import device as device_lib
from bloomscene_tpu_torch.config import GSConfig
from bloomscene_tpu_torch.convert import model_from_jax_params
from bloomscene_tpu_torch.models.model import init_model
from bloomscene_tpu_torch.models.render import prefilter_anchors, render
from bloomscene_tpu_torch.pipeline import bloomscene as pipeline
from bloomscene_tpu_torch.scene.cameras import camera_from_rt
from bloomscene_tpu_torch.scene.dataset import _camera_from_nerf_frame
from bloomscene_tpu_torch.scene.trajectory import get_camera_paths

torch.set_num_threads(2)
NARROW = dict(feat_dim=16, n_offsets=4, resolutions_3d=(18, 24, 33),
              log2_hashmap_size_3d=10, resolutions_2d=(130,),
              log2_hashmap_size_2d=10, voxel_size=0.08,
              max_splats_per_tile=256)


def jax_model(pts, rng, cfg, capacity=None):
    """A JAX-package ``Model`` whose parameters are drawn with numpy:
    anchors from the JAX package's init_from_points (at ``capacity``, by
    default its bucket), features and offsets at a trained scale (both are
    zero at init), heads with torch's default Linear bounds, hash tables
    uniform in +-1e-4."""
    from bloomscene_tpu.models.model import Model, mix_spec
    state, _ = jax_anchors.init_from_points(
        pts, n_offsets=cfg.n_offsets, feat_dim=cfg.feat_dim,
        voxel_size=cfg.voxel_size, capacity=capacity)
    C, F, K = state.capacity, cfg.feat_dim, cfg.n_offsets
    state = state._replace(
        feat=jnp.asarray(rng.normal(0, 1, (C, F)).astype(np.float32)),
        offset=jnp.asarray(rng.normal(0, 0.5, (C, K, 3)).astype(np.float32)))

    def mlp(*dims):
        return [{'w': jnp.asarray(rng.uniform(-1, 1, (i, o)).astype(
                    np.float32) / np.float32(np.sqrt(i))),
                 'b': jnp.asarray(rng.uniform(-1, 1, o).astype(
                     np.float32) / np.float32(np.sqrt(i)))}
                for i, o in zip(dims[:-1], dims[1:])]
    spec = mix_spec(cfg)
    ctx = spec.output_dim
    heads = {'opacity': mlp(F + 4, F, K), 'cov': mlp(F + 4, F, 7 * K),
             'color': mlp(F + 4, F, 3 * K),
             'grid': mlp(ctx, 2 * F, (F + 6 + 3 * K) * 2 + 3),
             'deform': mlp(ctx, 2 * F, 2 * K)}
    grid = {k: jnp.asarray(rng.uniform(-1e-4, 1e-4, s.n_params * s.n_features)
                           .astype(np.float32))
            for k, s in (('xyz', spec.spec_xyz), ('xy', spec.spec_2d),
                         ('xz', spec.spec_2d), ('yz', spec.spec_2d))}
    return Model(state=state, heads=heads, grid=grid,
                 bounds=jax_anchors.update_anchor_bounds(state))


@pytest.fixture(scope='module')
def models():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1, 1, (1500, 3)).astype(np.float32)
    pts[:, 2] += 2.5
    m = jax_model(pts, rng, JaxConfig(**NARROW))
    tm = model_from_jax_params(jax.tree.map(np.asarray, m),
                               GSConfig(**NARROW), device='cpu')
    return m, tm


def test_render_matches_jax(models):
    m, tm = models
    pallas_blend.INTERPRET = True
    try:
        cam = jax_camera(np.eye(3), np.zeros(3), 1.0, 1.0, 64, 64)
        arrs = cam.device_arrays()
        vis = jax_prefilter(m, cam.intrinsics, arrs)
        vcap = 2048
        assert int(vis.sum()) <= vcap < m.state.capacity
        rj = jax.jit(lambda mm, cc, vv: jax_render(
            mm, cam.intrinsics, cc, JaxConfig(**NARROW), mode='eval',
            visible=vv, visible_capacity=vcap, pair_capacity=16384,
            packed_capacity=16384, backend='pallas'))(m, arrs, vis)
    finally:
        pallas_blend.INTERPRET = False
    tcam = camera_from_rt(np.eye(3), np.zeros(3), 1.0, 1.0, 64, 64)
    tarrs = tcam.device_arrays('cpu')
    tvis = prefilter_anchors(tm, tcam.intrinsics, tarrs)
    np.testing.assert_array_equal(tvis.numpy(), np.asarray(vis))
    rt = render(tm, tcam.intrinsics, tarrs, GSConfig(**NARROW), mode='eval',
                visible=tvis, visible_capacity=vcap, pair_capacity=16384,
                packed_capacity=16384)
    assert int(rt.bins.num_pairs) > 0
    assert int(rt.bins.tile_overflow) == int(rj.tile_overflow)
    assert int(rt.bins.pair_overflow) == int(rj.pair_overflow) == 0
    assert int(rt.bins.packed_overflow) == int(rj.packed_overflow) == 0
    np.testing.assert_allclose(rt.out.color.numpy(), rj.out.color, atol=1e-4)
    np.testing.assert_allclose(rt.out.alpha.numpy(), rj.out.alpha, atol=1e-4)
    np.testing.assert_allclose(rt.out.final_T.numpy(), rj.out.final_T,
                               atol=1e-4)
    np.testing.assert_allclose(rt.out.depth.numpy(), rj.out.depth,
                               rtol=1e-3, atol=1e-6)


def test_render_model_matches_per_camera_render(models, monkeypatch):
    """The measured-capacity orbit renderer gives the frames a plain
    per-camera dense render gives (compaction and snug buffers change no
    pixel)."""
    _, tm = models
    cfg = GSConfig(**NARROW)
    monkeypatch.setattr(pipeline, 'EVAL_VCAP_GRANULE', 64)
    frames = get_camera_paths(12)['rotate360']['frames'][:3]
    cams = [_camera_from_nerf_frame(
        np.array(f['transform_matrix']) @ np.diag([1, 1, 1, 1.0]),
        1.0, 1.0, 64, 64) for f in frames]
    stats = []
    rgb, depth, fps = pipeline.render_model(tm, cams, cfg, mode='eval',
                                            device='cpu', frame_stats=stats)
    assert len(rgb) == 3 and fps > 0
    assert all(s['visible_capacity'] is not None for s in stats)
    assert all(s['visible_capacity'] < tm.state.capacity for s in stats)
    assert all(s['pair_overflow'] == s['packed_overflow'] == 0 for s in stats)
    for cam, img, dep in zip(cams, rgb, depth):
        res = render(tm, cam.intrinsics, cam.device_arrays('cpu'), cfg,
                     mode='eval', pair_capacity=1 << 16)
        assert int(res.bins.pair_overflow) == 0
        np.testing.assert_allclose(img, np.clip(res.out.color.numpy(), 0, 1),
                                   atol=1e-5)
        np.testing.assert_allclose(dep, res.out.depth.numpy(), atol=1e-5,
                                   rtol=1e-5)


def test_entry_points_raise_without_cuda():
    """Entry points default to device='cuda' and raise without it; there
    is no silent CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        device_lib.resolve_device()
    pts = np.random.default_rng(0).uniform(-1, 1, (64, 3)).astype(np.float32)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        init_model(0, pts, GSConfig(**NARROW))
    cam = camera_from_rt(np.eye(3), np.zeros(3), 1.0, 1.0, 32, 32)
    model, _ = init_model(0, pts, GSConfig(**NARROW), device='cpu')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        pipeline.render_model(model, [cam], GSConfig(**NARROW))
