"""The port's batched trainer (``make_dp_train_step``,
``Trainer(dp_batch=B)``) on the CPU, against the JAX package's
single-device twin (``make_dp_train_step(..., mesh=None)``).

- One step over two distinct views with the statistics on, at phase 0
  and at phase 2 (the hash-grid context, each view's adaptive noise from
  JAX's draws for that view's key, given through ``noise=``, and the
  rate): the loss within rtol 1e-5 and the rate within rtol 1e-4, the
  leaves within rtol 5e-3 and atol 1e-4 where the gradient is resolved
  (``test_torch_train.assert_params_match``, the tolerance of
  tests/test_training.py:195, with its wider floor for the context's
  path at phase 2), the view-counting statistics (``anchor_demon``,
  ``offset_denom``) exact and the summed opacities within
  test_accumulate_stats_matches_jax's rtol 1e-6 at phase 0 (at phase 2,
  decoded through the context, within the single phase-2 step's rtol
  5e-3 and atol 1e-4: 5.9e-6 relative at most on this scene); the
  summed gradient norms within ``check_step``'s rtol 5e-3 and atol 1e-4,
  since they carry the two blends' gradient rounding.
- tests/test_parallel.py's identical-views property on the port: one
  batched step over 4 copies of one view equals one single-view step
  (loss rtol 1e-5, leaves atol 1e-5 and rtol 1e-4), and every visible
  anchor counts 4 views.
- ``Trainer(dp_batch=4).run`` over one camera against JAX's
  ``Trainer(dp_batch=4)``: four phase-0 steps with densification at steps
  2 and 4, the same losses within rtol 1e-4 and the surgeries at the same
  steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bloomscene_tpu.config import GSConfig as JaxConfig
from bloomscene_tpu.models import densify as jax_densify
from bloomscene_tpu.models.anchors import update_anchor_bounds as jax_bounds
from bloomscene_tpu.models.model import init_model as jax_init_model
from bloomscene_tpu.scene.cameras import camera_from_rt as jax_camera
from bloomscene_tpu.train.loop import Trainer as JaxTrainer
from bloomscene_tpu.train.loop import make_dp_train_step as jax_dp_step
from bloomscene_tpu.train.optim import make_optimizer as jax_optimizer
from bloomscene_tpu_torch.config import GSConfig
from bloomscene_tpu_torch.convert import (model_from_jax_params,
                                          model_to_numpy)
from bloomscene_tpu_torch.models import densify
from bloomscene_tpu_torch.scene.cameras import camera_from_rt
from bloomscene_tpu_torch.train.loop import (Trainer, make_dp_train_step,
                                             make_train_step, stack_views)
from bloomscene_tpu_torch.train.optim import Adam, make_trainable
from test_torch_train import (assert_params_match, jax_moments, jax_step_noise,
                              named_jax, named_port)

torch.set_num_threads(2)
# tests/test_parallel.py's scene and config, with the slots a tile raised
# from 128 so that no splat is dropped at 32 px
CFG = dict(voxel_size=0.12, max_splats_per_tile=1024)
SIZE = 32


@pytest.fixture(scope='module')
def scene():
    """A JAX model with its bounds, its voxel size, and three views (the
    cameras a little apart, each with its own random image)."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.8, 0.8, (250, 3)).astype(np.float32)
    pts[:, 2] += 2.5
    m, vs = jax_init_model(jax.random.PRNGKey(0), pts, JaxConfig(**CFG))
    m = m._replace(bounds=jax_bounds(m.state))
    cams = [(np.array([0.1 * k, 0.0, 0.0]),
             rng.uniform(0, 1, (SIZE, SIZE, 3)).astype(np.float32),
             rng.uniform(1, 4, (SIZE, SIZE)).astype(np.float32))
            for k in range(3)]
    return m, vs, cams


def port_views(cams):
    out = []
    for t, img, dep in cams:
        cam = camera_from_rt(np.eye(3), t, 1.0, 1.0, SIZE, SIZE)
        out.append((cam.device_arrays('cpu'), torch.from_numpy(img),
                    torch.from_numpy(dep)))
    return cam.intrinsics, out


def jax_views(cams):
    out = []
    for t, img, dep in cams:
        cam = jax_camera(np.eye(3), t, 1.0, 1.0, SIZE, SIZE)
        out.append((cam.device_arrays(), jnp.asarray(img), jnp.asarray(dep)))
    return cam.intrinsics, out


def port_model(m, cfg):
    return make_trainable(model_from_jax_params(jax.tree.map(np.asarray, m),
                                                cfg, device='cpu'))


@pytest.mark.parametrize('phase', [0, 2])
def test_dp_step_matches_jax(scene, phase):
    m, _, cams = scene
    jcfg, cfg = JaxConfig(**CFG), GSConfig(**CFG)
    idx = np.array([0, 2])
    jintr, jv = jax_views(cams)
    opt = jax_optimizer(jcfg, 1.0, m)
    jstep = jax_dp_step(jcfg, jintr, opt, jnp.zeros(3))
    jcams = jax.tree.map(lambda *xs: jnp.stack(xs), *[c for c, _, _ in jv])
    keys = jax.random.split(jax.random.PRNGKey(1), 2)
    jm, jopt_state, jstats, jmet = jstep(
        m, opt.init(m), jax_densify.init_stats(m.state.capacity,
                                               jcfg.n_offsets),
        jcams, jnp.stack([g for _, g, _ in jv]),
        jnp.stack([d for _, _, d in jv]), jnp.asarray(idx),
        keys, phase=phase, track_stats=True)

    intr, views = port_views(cams)
    tm = port_model(m, cfg)
    adam = Adam(cfg, 1.0, tm)
    step = make_dp_train_step(cfg, intr, adam, torch.zeros(3))
    # each view decodes with the draws JAX takes from that view's key
    noise = ([jax_step_noise(k, phase, tm.state.capacity, cfg) for k in keys]
             if phase else None)
    tm, stats, met = step(tm, densify.init_stats(tm.state.capacity,
                                                 cfg.n_offsets, 'cpu'),
                          *stack_views(views), idx, phase=phase,
                          track_stats=True, noise=noise)
    assert int(met.skipped) == 0 and int(met.tile_overflow) == 0
    np.testing.assert_allclose(float(met.loss), float(jmet.loss), rtol=1e-5)
    np.testing.assert_allclose(float(met.bit_per_param),
                               float(jmet.bit_per_param), rtol=1e-4)
    assert (float(jmet.bit_per_param) > 0) == (phase == 2)
    np.testing.assert_allclose(float(met.psnr), float(jmet.psnr), rtol=1e-5)
    assert float(met.n_visible_anchors) == float(jmet.n_visible_anchors)
    assert_params_match(named_port(model_to_numpy(tm)), named_jax(jm),
                        jax_moments(jopt_state), adam, steps=1, phase=phase)
    for f in ('anchor_demon', 'offset_denom'):
        np.testing.assert_array_equal(getattr(stats, f).numpy(),
                                      np.asarray(getattr(jstats, f)),
                                      err_msg=f)
    assert float(stats.anchor_demon.max()) == 2.0
    # at phase 2 the opacity is decoded through the hash-grid context,
    # whose multiply-adds XLA contracts under jit: there the single step's
    # phase-2 tolerance (check_step) holds it
    np.testing.assert_allclose(stats.opacity_accum.numpy(),
                               np.asarray(jstats.opacity_accum),
                               **(dict(rtol=1e-6, atol=1e-9) if phase == 0
                                  else dict(rtol=5e-3, atol=1e-4)))
    np.testing.assert_allclose(stats.offset_grad_accum.numpy(),
                               np.asarray(jstats.offset_grad_accum),
                               rtol=5e-3, atol=1e-4)


def test_dp_step_over_identical_views_equals_one_view(scene):
    m, _, cams = scene
    cfg = GSConfig(**CFG)
    intr, views = port_views(cams[:1])
    B = 4
    single, batched = port_model(m, cfg), port_model(m, cfg)
    adam1, adam_b = Adam(cfg, 1.0, single), Adam(cfg, 1.0, batched)
    _, _, met1 = make_train_step(cfg, intr, adam1, torch.zeros(3))(
        single, densify.init_stats(single.state.capacity, cfg.n_offsets,
                                   'cpu'),
        *views[0], phase=0, track_stats=True)
    _, stats_b, met_b = make_dp_train_step(cfg, intr, adam_b, torch.zeros(3))(
        batched, densify.init_stats(batched.state.capacity, cfg.n_offsets,
                                    'cpu'),
        *stack_views(views), np.zeros(B, np.int64), phase=0,
        track_stats=True)
    np.testing.assert_allclose(float(met_b.loss), float(met1.loss),
                               rtol=1e-5)
    for (name, _, a), (_, _, b) in zip(adam1.params, adam_b.params):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=name)
    assert float(stats_b.anchor_demon.max()) == float(B)


def test_dp_trainer_matches_jax_dp_trainer(scene):
    m, vs, cams = scene
    kw = dict(CFG, iterations=4, start_stat=0, update_from=1,
              update_interval=2, update_until=100)
    jcfg, cfg = JaxConfig(**kw), GSConfig(**kw)
    jintr, jv = jax_views(cams[:1])
    jtr = JaxTrainer(m, jcfg, jintr, vs, seed=5, dp_batch=4)
    jtr.run(jv, log_every=1)

    intr, views = port_views(cams[:1])
    tr = Trainer(model_from_jax_params(jax.tree.map(np.asarray, m), cfg,
                                       device='cpu'),
                 cfg, intr, vs, seed=5, device='cpu', dp_batch=4)
    tr.run(views, log_every=1, device_loop=True)     # dp_batch comes first
    assert [r['iteration'] for r in tr.history] == [1, 2, 3, 4]
    for rec, jrec in zip(tr.history, jtr.history):
        np.testing.assert_allclose(rec['loss'], jrec['loss'], rtol=1e-4)
        assert rec['skipped'] == 0 and rec['tile_overflow'] == 0
    dens = [r['iteration'] for r in tr.history if 'densify_n_alive' in r]
    jdens = [r['iteration'] for r in jtr.history if 'densify_n_alive' in r]
    assert dens == jdens == [2, 4]
    assert tr.graph_log == []
    assert tr.model.state.capacity == jtr.model.state.capacity
