"""The port's device loop (``Trainer.run(device_loop=True)``) on the CPU.

On the card the loop replays a CUDA graph of the step (``chip_smoke.py``
holds it to the host loop bit for bit there); on the CPU the same chunks
run the same ``loop_step`` eagerly, with the same static buffers, step
counter and Adam scalar table. Here:

- ``Trainer._chunk_end`` equals the JAX trainer's, called unbound on a
  stand-in that has only ``cfg``, at every step of four schedules (the
  chip_smoke schedule, both configs of tests/test_training.py's device
  loop tests, the default 2,990 steps) at ``max_chunk`` 4 and 50;
- the device loop ends on the host loop's state bit for bit (every leaf,
  Adam's moments and count, the statistics, the three generators, every
  record but the surgery's wall time) over tests/test_training.py's
  chunking schedule (phases 0-2, densification at chunk ends) with two
  cameras at 32 px;
- it matches the JAX package's device loop over 4 phase-0 steps of one
  camera: the loss within rtol 1e-4 and the leaves within rtol 5e-3 and
  atol 1e-4 (tests/test_training.py:195,199), where the gradient is
  resolved (``test_torch_train.assert_params_match``: below the noise
  floor Adam's eps turns rounding noise into a step of the learning rate
  either way);
- Adam's device-scalar path equals its float path bit for bit over 24
  updates (on the card too, where a card is);
- the sync-free ``compact_visible`` equals the ``torch.nonzero`` form
  and JAX's ``jnp.nonzero(size=..., fill_value=C)`` bit for bit, indices
  and gathered rows: none visible, some, more than the bucket;
- a checkpoint that the ``checkpoint_every`` callback writes during a
  device-loop run holds the chunk's last step and resumes to the straight
  run's state bit for bit;
- ``fit_single_view(device_loop=True)`` gives the host loop's losses and
  render bit for bit at 32 px, and the render improves.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bloomscene_tpu.config import GSConfig as JaxConfig
from bloomscene_tpu.models.model import init_model as jax_init_model
from bloomscene_tpu.scene.cameras import camera_from_rt as jax_camera
from bloomscene_tpu.train.loop import Trainer as JaxTrainer
from bloomscene_tpu_torch.config import GSConfig
from bloomscene_tpu_torch.convert import model_from_jax_params, model_to
from bloomscene_tpu_torch.convert import model_to_numpy
from bloomscene_tpu_torch.examples import fit_single_view
from bloomscene_tpu_torch.models.model import init_model
from bloomscene_tpu_torch.models.render import compact_visible
from bloomscene_tpu_torch.scene.cameras import camera_from_rt
from bloomscene_tpu_torch.train.loop import Trainer
from bloomscene_tpu_torch.train.optim import Adam, make_trainable
from chip_smoke import SCHEDULE
from test_torch_resume import assert_same_trainer
from test_torch_train import (assert_params_match, jax_moments, named_jax,
                              named_port)

torch.set_num_threads(2)
SIZE = 32
# tests/test_training.py's small_cfg and its two device-loop schedules
SMALL = dict(voxel_size=0.08, max_splats_per_tile=2048, iterations=120,
             start_stat=10, update_from=20, update_interval=40,
             update_until=110, densify_pause_from=10 ** 9,
             noise_from_step=10 ** 9, context_from_step=10 ** 9)
SHORT = dict(SMALL, iterations=4, start_stat=10 ** 9, update_from=10 ** 9)
CHUNKING = dict(SMALL, iterations=24, start_stat=4, update_from=4,
                update_interval=8, update_until=21, noise_from_step=8,
                context_from_step=17)
CONFIGS = {'schedule': SCHEDULE, 'short': SHORT, 'chunking': CHUNKING,
           'default': {}}


def sphere_points(n: int, seed: int) -> np.ndarray:
    """tests/test_training.py's synthetic_scene."""
    rng = np.random.default_rng(seed)
    th, ph = rng.uniform(0, np.pi, n), rng.uniform(0, 2 * np.pi, n)
    pts = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                    np.cos(th)], -1).astype(np.float32) * 0.7
    pts[:, 2] += 2.5
    return pts


def disk_target(size: int, shade: float = 0.2):
    """tests/test_training.py's target: a colored disk and its depth."""
    yy, xx = np.mgrid[0:size, 0:size]
    inside = (xx - size // 2) ** 2 + (yy - size // 2) ** 2 < (size // 3) ** 2
    img = np.zeros((size, size, 3), np.float32)
    img[inside] = [0.8, 0.4, shade]
    return img, np.where(inside, 2.5, 0.0).astype(np.float32)


def two_views():
    """Two cameras with their own targets, so the camera draws matter."""
    views = []
    for k in range(2):
        cam = camera_from_rt(np.eye(3), np.array([0.15 * k, 0.0, 0.0]), 1.0,
                             1.0, SIZE, SIZE)
        img, depth = disk_target(SIZE, 0.2 + 0.5 * k)
        views.append((cam.device_arrays('cpu'), torch.from_numpy(img),
                      torch.from_numpy(depth)))
    return cam, views


def same_records(a: list, b: list) -> None:
    """Every record equal, but the surgery's wall time."""
    assert [r['iteration'] for r in a] == [r['iteration'] for r in b]
    for ra, rb in zip(a, b):
        ra = {k: v for k, v in ra.items() if k != 'densify_time_s'}
        rb = {k: v for k, v in rb.items() if k != 'densify_time_s'}
        assert ra == rb, (ra, rb)


@pytest.mark.parametrize('max_chunk', [4, 50])
@pytest.mark.parametrize('config', sorted(CONFIGS))
def test_chunk_end_matches_jax(config, max_chunk):
    kw = CONFIGS[config]
    port = types.SimpleNamespace(cfg=GSConfig(**kw))
    ref = types.SimpleNamespace(cfg=JaxConfig(**kw))
    n = port.cfg.iterations
    got = [Trainer._chunk_end(port, it, n, max_chunk)
           for it in range(1, n + 1)]
    want = [JaxTrainer._chunk_end(ref, it, n, max_chunk)
            for it in range(1, n + 1)]
    assert got == want


def test_device_loop_equals_host_loop_bitwise():
    cfg = GSConfig(**CHUNKING)
    cam, views = two_views()
    model, vs = init_model(2, sphere_points(120, 3), cfg, capacity=512,
                           device='cpu')
    trainers = {}
    for device_loop in (False, True):
        tr = Trainer(model_to(model, 'cpu'), cfg, cam.intrinsics, vs,
                     seed=11, device='cpu')
        tr.run(views, log_every=4, device_loop=device_loop, max_chunk=4)
        trainers[device_loop] = tr
    host, loop = trainers[False], trainers[True]
    dens = [r['iteration'] for r in host.history if 'densify_n_alive' in r]
    assert dens == [8, 16]
    assert any(r['bit_per_param'] > 0 for r in host.history)
    assert_same_trainer(host, loop)
    same_records(host.history, loop.history)
    assert loop.graph_log == []          # no graph on the CPU


def test_device_loop_matches_jax_device_loop():
    jcfg, cfg = JaxConfig(**SHORT), GSConfig(**SHORT)
    pts = sphere_points(250, 3)
    img, depth = disk_target(SIZE)
    jcam = jax_camera(np.eye(3), np.zeros(3), 1.0, 1.0, SIZE, SIZE)
    jm, vs = jax_init_model(jax.random.PRNGKey(2), pts, jcfg, capacity=512)
    jtr = JaxTrainer(jm, jcfg, jcam.intrinsics, vs, seed=11)
    jtr.run([(jcam.device_arrays(), jnp.asarray(img), jnp.asarray(depth))],
            log_every=1, device_loop=True, max_chunk=4)

    cam = camera_from_rt(np.eye(3), np.zeros(3), 1.0, 1.0, SIZE, SIZE)
    tm = model_from_jax_params(jax.tree.map(np.asarray, jm), cfg,
                               device='cpu')
    tr = Trainer(tm, cfg, cam.intrinsics, vs, seed=11, device='cpu')
    tr.run([(cam.device_arrays('cpu'), torch.from_numpy(img),
             torch.from_numpy(depth))], log_every=1, device_loop=True,
           max_chunk=4)
    assert [r['iteration'] for r in tr.history] == [1, 2, 3, 4]
    for rec, jrec in zip(tr.history, jtr.history):
        np.testing.assert_allclose(rec['loss'], jrec['loss'], rtol=1e-4)
    assert_params_match(named_port(model_to_numpy(tr.model)),
                        named_jax(jtr.model), jax_moments(jtr.opt_state),
                        tr.optimizer, steps=4)


@pytest.mark.parametrize('device', ['cpu', pytest.param(
    'cuda', marks=pytest.mark.cuda)])
def test_adam_device_scalars_bitwise(device):
    if device == 'cuda' and not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    cfg = GSConfig(**SMALL)
    model, _ = init_model(2, sphere_points(250, 3), cfg, capacity=512,
                          device=device)
    a = make_trainable(model_to(model, device))
    b = make_trainable(model_to(model, device))
    opt_a, opt_b = Adam(cfg, 1.3, a), Adam(cfg, 1.3, b)
    n = 24
    table = torch.from_numpy(opt_b.scalar_table(n)).to(device)
    gen = torch.Generator().manual_seed(0)
    for count in range(n):
        grads = [(torch.randn(p.shape, generator=gen)
                  * 10.0 ** (count % 5 - 4)).to(device)
                 for _, _, p in opt_a.params]
        opt_a.step(grads)
        opt_b.step(grads, table[count])
        assert opt_a.count == count + 1 and opt_b.count == 0
    for (name, _, p), (_, _, q) in zip(opt_a.params, opt_b.params):
        assert torch.equal(p, q), name
    for x, y in zip(opt_a.m + opt_a.v, opt_b.m + opt_b.v):
        assert torch.equal(x, y)


@pytest.mark.parametrize('share', [0.0, 0.3, 0.9])
def test_compact_visible_matches_nonzero_and_jax(share):
    cfg = GSConfig(voxel_size=0.1)
    model, _ = init_model(0, sphere_points(300, 1), cfg, capacity=512,
                          device='cpu')
    bucket = 128
    C = model.state.capacity
    visible = (torch.from_numpy(np.random.default_rng(4).uniform(size=C)
                                < share) & model.state.alive)
    n_visible = int(visible.sum())
    assert (n_visible == 0) == (share == 0.0)
    assert (n_visible > bucket) == (share == 0.9)
    idx = torch.nonzero(visible).flatten()[:bucket]
    want = torch.cat([idx, torch.full((bucket - idx.shape[0],), C)])
    sub, got = compact_visible(model, visible, bucket)
    assert got.dtype == torch.int64 and torch.equal(got, want)
    jax_idx = np.asarray(jnp.nonzero(jnp.asarray(visible.numpy()),
                                     size=bucket, fill_value=C)[0])
    np.testing.assert_array_equal(got.numpy(), jax_idx)
    ok = want < C
    safe = torch.clamp(want, max=C - 1)
    ref = model.state.gather_rows(safe, ok & model.state.alive[safe])
    for f, x in ref.flat_leaves().items():
        assert torch.equal(sub.state.flat_leaves()[f], x), f


def test_checkpoint_every_resumes_device_loop_bitwise(tmp_path):
    """The first file that ``BloomScene.training``'s ``checkpoint_every=6``
    callback writes, on a device loop of chunks of 4 through phases 0-2
    and a densification at step 8: the record of step 6 writes the trainer
    at its chunk's last step, 8."""
    cfg = GSConfig(**dict(CHUNKING, iterations=12, noise_from_step=4,
                          context_from_step=9))
    cam, views = two_views()
    model, vs = init_model(2, sphere_points(120, 3), cfg, capacity=512,
                           device='cpu')
    ckpt = str(tmp_path / 'train_ckpt.npz')
    straight = Trainer(model_to(model, 'cpu'), cfg, cam.intrinsics, vs,
                       seed=11, device='cpu')
    saved = []

    def callback(rec):
        it = int(rec.get('iteration', 0))
        if it and it % 6 == 0 and not saved:
            straight.save(ckpt)
            saved.append((it, straight.step))
    straight.run(views, log_every=2, callback=callback, device_loop=True,
                 max_chunk=4)
    assert saved == [(6, 8)]
    resumed = Trainer(model_to(model, 'cpu'), cfg, cam.intrinsics, vs,
                      seed=11, device='cpu')
    resumed.restore(ckpt)
    assert resumed.step == 8
    resumed.run(views, log_every=2, device_loop=True, max_chunk=4)
    assert_same_trainer(straight, resumed)
    same_records(straight.history[-2:], resumed.history)


def test_fit_single_view_device_loop():
    kw = dict(steps=8, res=SIZE, n_points=150, device='cpu', log_every=4)
    host = fit_single_view.fit(**kw)
    loop = fit_single_view.fit(**kw, device_loop=True)
    for k in ('loss_first', 'loss_last', 'l1_before', 'l1_after'):
        assert loop[k] == host[k], k
    assert loop['l1_after'] < loop['l1_before']
