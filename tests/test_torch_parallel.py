"""The port's parallel layer (``bloomscene_tpu_torch/parallel``) on the CPU:
2 gloo ranks over a ``file://`` store, spawned by
``parallel.launch.spawn`` and joined under a deadline, so a hang fails the
test instead of stalling the suite.

The sharded paths are held to the port's own unsharded paths, which the
other tests hold to JAX, and to JAX's unsharded functions on small inputs
(JAX's mesh paths are not run: they cost minutes a test on the CPU):

- ``bin_splats(tile_shards=S)``: ``perm`` and ``pos`` (and every other
  field) bitwise JAX's for S = 1, 2, 4.
- ``make_tile_parallel_render`` on a (1, 2) mesh at 64x64 on
  tests/test_parallel.py's scene (``GSConfig(voxel_size=0.12,
  max_splats_per_tile=128)``, 250 points), eval and train mode: bitwise
  the port's ``render``, the blend cut into 2 strips; against JAX's
  unsharded ``render``, color within 1e-5 and depth within 1e-4
  (tests/test_parallel.py:86-89). At 48x48 (9 tiles, odd) every rank
  blends the whole grid, and ``TileBins.tile_shards`` says so.
- ``make_tile_parallel_train_step``: loss and every leaf bitwise the
  port's single-view step.
- The data-parallel step on a (2, 1) mesh with B = 4 against the port's
  ``dp_batch`` step: loss rtol 1e-5, leaves atol 1e-5 and rtol 1e-4, the
  view-counting statistics exact; B identical views give
  ``anchor_demon`` B (tests/test_parallel.py:56-69). Both steps sum the
  views' gradients in view order, so they are also bitwise equal, and so
  are the ranks.
- ``Trainer(mesh=(2, 1), dp_batch=4)`` over 10 steps through phases 0, 1
  and 2 with one ``adjust_anchor`` against ``Trainer(dp_batch=4)``: loss
  rtol 5e-4 and atol 1e-5, psnr rtol 5e-3 (tests/test_parallel.py:185-189),
  the same surgeries and alive count, and bitwise the same state; the two
  ranks bitwise equal to each other (leaves, Adam's moments, statistics,
  generators); ``save`` from rank 0 restored on both ranks; ``dp_batch``
  not divisible by the data axis refused with JAX's message.
"""
import functools
import os
import threading

import numpy as np
import pytest
import torch

from bloomscene_tpu_torch.config import GSConfig
from bloomscene_tpu_torch.models import densify
from bloomscene_tpu_torch.models.anchors import \
    update_anchor_bounds as port_bounds
from bloomscene_tpu_torch.models.model import init_model as port_init_model
from bloomscene_tpu_torch.models.render import render
from bloomscene_tpu_torch.parallel.launch import spawn
from bloomscene_tpu_torch.scene.cameras import camera_from_rt
from bloomscene_tpu_torch.train.loop import (Trainer, make_dp_train_step,
                                             make_train_step, stack_views)
from bloomscene_tpu_torch.train.optim import Adam, make_trainable

torch.set_num_threads(2)
CFG = dict(voxel_size=0.12, max_splats_per_tile=128)   # test_parallel.py
# the batched steps at tile 4 without remat: the plain blend walks its
# slots in Python, as many as the fullest tile holds
DP_CFG = dict(voxel_size=0.12, max_splats_per_tile=1024, tile_size=4,
              remat=False)
TRAINER_CFG = dict(DP_CFG, iterations=10, start_stat=2, update_from=4,
                   update_interval=6, update_until=22, densify_pause_from=98,
                   densify_pause_until=99, noise_from_step=3,
                   context_from_step=6)
SIZE, DP_SIZE, ODD_SIZE = 64, 32, 48
DP_POINTS = 40
DP_IDX, B = [0, 2, 1, 0], 4
SPAWN_TIMEOUT = 120


def load_model(out, name='model'):
    return make_trainable(torch.load(os.path.join(out, f'{name}.pt'),
                                     weights_only=False))


def dp_views(out):
    with np.load(os.path.join(out, 'views.npz')) as f:
        imgs, deps = f['imgs'], f['deps']
    views = []
    for k, (img, dep) in enumerate(zip(imgs, deps)):
        cam = camera_from_rt(np.eye(3), np.array([0.1 * k, 0.0, 0.0]), 1.0,
                             1.0, DP_SIZE, DP_SIZE)
        views.append((cam.device_arrays('cpu'), torch.from_numpy(img),
                      torch.from_numpy(dep)))
    return cam.intrinsics, views


def tile_results(out, mesh):
    """The tile-parallel render (eval, train) and train step on ``mesh``
    (None: the port's single-process render and step)."""
    from bloomscene_tpu_torch.parallel.sharded import (
        make_tile_parallel_render, make_tile_parallel_train_step)
    cfg = GSConfig(**CFG)
    res = {}
    for size in (SIZE, ODD_SIZE):
        cam = camera_from_rt(np.eye(3), np.zeros(3), 1.0, 1.0, size, size)
        intr, arrs = cam.intrinsics, cam.device_arrays('cpu')
        group = None if mesh is None else mesh.axis('tile')
        r = render(load_model(out), intr, arrs, cfg, mode='eval',
                   tile_group=group)
        res[f'shards_{size}'] = r.bins.tile_shards
        res[f'eval_{size}'] = (r.out.color, r.out.depth)
        if size == SIZE and mesh is not None:
            r1 = make_tile_parallel_render(cfg, intr, mesh, mode='eval')
            res['eval_fn'] = tuple(r1(load_model(out), arrs)[:2])
            r1 = make_tile_parallel_render(cfg, intr, mesh, mode='train')
            res['train_fn'] = tuple(r1(load_model(out), arrs)[:2])
    cam = camera_from_rt(np.eye(3), np.zeros(3), 1.0, 1.0, SIZE, SIZE)
    intr, arrs = cam.intrinsics, cam.device_arrays('cpu')
    res['train'] = tuple(render(load_model(out), intr, arrs, cfg,
                                mode='train').out[:2])
    with np.load(os.path.join(out, 'views.npz')) as f:
        img, dep = torch.from_numpy(f['img64']), torch.from_numpy(f['dep64'])
    model = load_model(out)
    adam = Adam(cfg, 1.0, model)
    if mesh is None:
        _, _, met = make_train_step(cfg, intr, adam, torch.zeros(3))(
            model, None, arrs, img, dep, phase=0, track_stats=False)
        loss = met.loss
    else:
        _, loss = make_tile_parallel_train_step(
            cfg, intr, adam, torch.zeros(3), mesh)(model, arrs, img, dep)
    res['step_loss'] = loss
    res['step_leaves'] = [t.detach().clone() for _, _, t in adam.params]
    return res


def dp_results(out, mesh):
    """One batched step over DP_IDX and one over B copies of view 0 with
    the statistics on (mesh None: the single-process ``dp_batch`` step)."""
    cfg = GSConfig(**DP_CFG)
    intr, views = dp_views(out)
    res = {}
    for name, idx in (('dp', DP_IDX), ('same', [0] * B)):
        model = load_model(out, 'dp_model')
        adam = Adam(cfg, 1.0, model)
        step = make_dp_train_step(cfg, intr, adam, torch.zeros(3), mesh=mesh)
        _, stats, met = step(model, densify.init_stats(
            model.state.capacity, cfg.n_offsets, 'cpu'), *stack_views(views),
            idx, phase=0, track_stats=True)
        res[name] = dict(metrics=[float(x) for x in met],
                         leaves=[t.detach().clone() for _, _, t in adam.params],
                         stats=[s.clone() for s in stats])
    return res


def trainer_state(tr) -> dict:
    return dict(leaves=[t.detach().clone() for t in tr._leaves()],
                m=[t.clone() for t in tr.optimizer.m],
                v=[t.clone() for t in tr.optimizer.v],
                count=tr.optimizer.count, stats=[s.clone() for s in tr.stats],
                noise_gen=tr.noise_gen.get_state(),
                rng=tr.rng.bit_generator.state,
                densify_rng=tr.densify_rng.bit_generator.state,
                step=tr.step)


def trainer_results(out, mesh):
    cfg = GSConfig(**TRAINER_CFG)
    intr, views = dp_views(out)
    with open(os.path.join(out, 'voxel.txt')) as f:
        vs = float(f.read())
    tr = Trainer(load_model(out, 'dp_model'), cfg, intr, vs, seed=11,
                 device='cpu', dp_batch=B, mesh=mesh)
    tr.run(views, log_every=1, device_loop=True)     # dp_batch comes first
    res = dict(history=tr.history, state=trainer_state(tr),
               alive=int(tr.model.state.alive.sum()))
    if mesh is not None:
        path = os.path.join(out, 'trainer.npz')
        tr.save(path)
        again = Trainer(load_model(out, 'dp_model'), cfg, intr, vs, seed=11,
                        device='cpu', dp_batch=B, mesh=mesh)
        again.restore(path)
        res['restored'] = trainer_state(again)
        try:
            Trainer(load_model(out, 'dp_model'), cfg, intr, vs, seed=11,
                    device='cpu', dp_batch=3, mesh=mesh)
            res['refusal'] = None
        except ValueError as e:
            res['refusal'] = str(e)
    return res


def two_rank_worker(rank, world, store, out):
    """One rank of the 2-rank job: the (1, 2) mesh's tile-parallel results
    and the (2, 1) mesh's data-parallel ones."""
    torch.set_num_threads(2)
    from bloomscene_tpu_torch.parallel.mesh import init_distributed, make_mesh
    init_distributed('gloo', f'file://{store}', world, rank, device='cpu')
    tile_mesh = make_mesh(1, 2)
    data_mesh = make_mesh(2, 1)
    res = {'mesh': (tile_mesh.shape, data_mesh.shape,
                    tile_mesh.axis('tile').index,
                    data_mesh.axis('data').index)}
    res['tile'] = tile_results(out, tile_mesh)
    res['dp'] = dp_results(out, data_mesh)
    res['trainer'] = trainer_results(out, data_mesh)
    torch.save(res, os.path.join(out, f'rank{rank}.pt'))


@pytest.fixture(scope='module')
def job(tmp_path_factory):
    """The JAX scene converted to the port and the batched steps' smaller
    scene (saved for the ranks), the views, the 2-rank job's results and
    the single-process results."""
    import jax
    from bloomscene_tpu.config import GSConfig as JaxConfig
    from bloomscene_tpu_torch.convert import model_from_jax_params
    from test_torch_render import jax_model
    out = str(tmp_path_factory.mktemp('parallel'))
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.8, 0.8, (250, 3)).astype(np.float32)
    pts[:, 2] += 2.5
    jm = jax_model(pts, rng, JaxConfig(**CFG), capacity=512)
    torch.save(model_from_jax_params(jax.tree.map(np.asarray, jm),
                                     GSConfig(**CFG), device='cpu'),
               os.path.join(out, 'model.pt'))
    # the batched steps' scene: DP_POINTS of the points, the port's init
    dm, vs = port_init_model(0, pts[:DP_POINTS], GSConfig(**DP_CFG),
                             device='cpu', capacity=256)
    torch.save(dm._replace(bounds=port_bounds(dm.state)),
               os.path.join(out, 'dp_model.pt'))
    with open(os.path.join(out, 'voxel.txt'), 'w') as f:
        f.write(repr(float(vs)))
    np.savez(os.path.join(out, 'views.npz'),
             imgs=rng.uniform(0, 1, (3, DP_SIZE, DP_SIZE, 3)
                              ).astype(np.float32),
             deps=rng.uniform(1, 4, (3, DP_SIZE, DP_SIZE)).astype(np.float32),
             img64=rng.uniform(0, 1, (SIZE, SIZE, 3)).astype(np.float32),
             dep64=np.zeros((SIZE, SIZE), np.float32))
    # the ranks run while this process takes the single-process results
    failed = []

    def ranks_job():
        try:
            spawn(two_rank_worker, 2, (os.path.join(out, 'store'), out),
                  timeout=SPAWN_TIMEOUT)
        except RuntimeError as e:
            failed.append(e)
    thread = threading.Thread(target=ranks_job)
    thread.start()
    try:
        single = dict(tile=tile_results(out, None), dp=dp_results(out, None),
                      trainer=trainer_results(out, None))
    finally:
        thread.join()
    if failed:
        raise failed[0]
    ranks = [torch.load(os.path.join(out, f'rank{r}.pt'), weights_only=False)
             for r in range(2)]
    return dict(ranks=ranks, single=single, jax_model=jm)


def bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_bitwise(a, b, what=''):
    assert a.shape == b.shape and a.dtype == b.dtype, what
    assert torch.equal(bits(a), bits(b)), what


@pytest.mark.parametrize('shards', [1, 2, 4])
def test_bin_splats_tile_shards_match_jax(shards):
    import jax
    import jax.numpy as jnp
    from bloomscene_tpu.ops.tiles import bin_splats as jax_bin_splats
    from bloomscene_tpu_torch.ops.tile_rasterizer import attr_rows
    from bloomscene_tpu_torch.ops.tiles import bin_splats
    from test_torch_tiles import assert_bins_equal, scene
    pj, pt, colors, op = scene(np.random.default_rng(shards), 150)
    rows = attr_rows(pt, torch.from_numpy(colors), torch.from_numpy(op))
    kw = dict(W=64, H=64, tile=16, pair_capacity=4096, tile_capacity=256)
    jb = jax.jit(functools.partial(
        jax_bin_splats, **kw, grad_index=True, need_entries=False,
        tile_shards=shards))(pj, opacities=jnp.asarray(op),
                             attr_rows=jnp.asarray(rows.numpy()))
    tb = bin_splats(pt, **kw, opacities=torch.from_numpy(op), grad_index=True,
                    attr_rows=rows, tile_shards=shards)
    assert tb.tile_shards == shards
    assert_bins_equal(jb, tb)
    if shards > 1:
        plain = bin_splats(pt, **kw, opacities=torch.from_numpy(op),
                           grad_index=True, attr_rows=rows)
        assert not torch.equal(tb.perm, plain.perm)
        # each strip takes every S-th occupancy rank
        counts = plain.counts[plain.perm.long()]
        L = 16 // shards
        for d in range(shards):
            assert torch.equal(tb.counts[tb.perm[d * L:(d + 1) * L].long()],
                               counts[d::shards])


def test_tile_parallel_render_bitwise_single_process(job):
    single = job['single']['tile']
    for rank in job['ranks']:
        assert rank['mesh'][0] == {'data': 1, 'tile': 2}
        got = rank['tile']
        assert got[f'shards_{SIZE}'] == 2
        for key in ('eval_64', 'eval_fn', 'train_fn', 'train'):
            ref = single['eval_64' if key.startswith('eval') else 'train']
            for a, b, nm in zip(got[key], ref, ('color', 'depth')):
                assert_bitwise(a, b, f'{key} {nm}')


def test_tile_parallel_render_matches_jax(job):
    import jax
    from bloomscene_tpu.config import GSConfig as JaxConfig
    from bloomscene_tpu.models.render import render as jax_render
    from bloomscene_tpu.scene.cameras import camera_from_rt as jax_camera
    cam = jax_camera(np.eye(3), np.zeros(3), 1.0, 1.0, SIZE, SIZE)
    ref = jax.jit(lambda m, c: jax_render(
        m, cam.intrinsics, c, JaxConfig(**CFG), phase=0, mode='train',
        key=jax.random.PRNGKey(2)).out)(job['jax_model'], cam.device_arrays())
    color, depth = (t.detach() for t in job['ranks'][0]['tile']['train_fn'])
    np.testing.assert_allclose(color.numpy(), np.asarray(ref.color),
                               atol=1e-5)
    np.testing.assert_allclose(depth.numpy(), np.asarray(ref.depth),
                               atol=1e-4)


def test_indivisible_grid_blends_whole_grid(job):
    single = job['single']['tile']
    assert single[f'shards_{ODD_SIZE}'] == 1
    for rank in job['ranks']:
        assert rank['tile'][f'shards_{ODD_SIZE}'] == 1
        for a, b in zip(rank['tile'][f'eval_{ODD_SIZE}'],
                        single[f'eval_{ODD_SIZE}']):
            assert_bitwise(a, b, 'whole-grid render')


def test_tile_parallel_train_step_bitwise_single_process(job):
    single = job['single']['tile']
    for rank in job['ranks']:
        assert_bitwise(rank['tile']['step_loss'], single['step_loss'], 'loss')
        assert len(rank['tile']['step_leaves']) == len(single['step_leaves'])
        for i, (a, b) in enumerate(zip(rank['tile']['step_leaves'],
                                       single['step_leaves'])):
            assert_bitwise(a, b, f'leaf {i}')


def test_dp_step_matches_batched_step(job):
    single = job['single']['dp']
    r0, r1 = (r['dp'] for r in job['ranks'])
    for name in ('dp', 'same'):
        got, want = r0[name], single[name]
        # the mean of the same per-view losses
        assert got['metrics'][0] == want['metrics'][0]
        np.testing.assert_allclose(got['metrics'], want['metrics'],
                                   rtol=1e-5)
        for i, (a, b) in enumerate(zip(got['leaves'], want['leaves'])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                       rtol=1e-4, err_msg=f'leaf {i}')
        for f in ('anchor_demon', 'offset_denom'):
            i = densify.DensifyStats._fields.index(f)
            assert torch.equal(got['stats'][i], want['stats'][i]), f
        # the ranks hold the one-process step, bit for bit
        assert r1[name]['metrics'] == want['metrics']
        for key in ('leaves', 'stats'):
            for a, b, c in zip(r0[name][key], r1[name][key], want[key]):
                assert_bitwise(a, b, f'{name} {key}: rank 0 against rank 1')
                assert_bitwise(a, c, f'{name} {key}: against one process')
    demon = densify.DensifyStats._fields.index('anchor_demon')
    assert float(r0['same']['stats'][demon].max()) == float(B)


def test_mesh_trainer_matches_batched_trainer(job):
    single = job['single']['trainer']
    r0, r1 = (r['trainer'] for r in job['ranks'])
    assert [h['iteration'] for h in r0['history']] == list(range(1, 11))
    assert len(r0['history']) == len(single['history'])
    for a, b in zip(r0['history'], single['history']):
        np.testing.assert_allclose(a['loss'], b['loss'], rtol=5e-4, atol=1e-5)
        np.testing.assert_allclose(a['psnr'], b['psnr'], rtol=5e-3)
        assert a['skipped'] == 0
    assert [h['iteration'] for h in r0['history'] if 'densify_n_alive' in h] \
        == [h['iteration'] for h in single['history']
            if 'densify_n_alive' in h] == [6]
    assert r0['alive'] == r1['alive'] == single['alive']
    # every record but the surgery's host seconds
    for a, b in zip(r0['history'], r1['history']):
        a, b = dict(a), dict(b)
        a.pop('densify_time_s', None)
        b.pop('densify_time_s', None)
        assert a == b
    # the ranks bitwise equal to each other and to the one-process trainer,
    # and after save and restore
    for other in (r1['state'], single['state'], r0['restored'],
                  r1['restored']):
        assert other['count'] == r0['state']['count']
        assert other['step'] == r0['state']['step'] == 10
        assert other['rng'] == r0['state']['rng']
        assert other['densify_rng'] == r0['state']['densify_rng']
        assert torch.equal(other['noise_gen'], r0['state']['noise_gen'])
        for key in ('leaves', 'm', 'v', 'stats'):
            assert len(other[key]) == len(r0['state'][key])
            for a, b in zip(other[key], r0['state'][key]):
                assert_bitwise(a, b, key)


def test_mesh_trainer_refuses_indivisible_batch(job):
    for rank in job['ranks']:
        assert rank['trainer']['refusal'] == (
            "dp_batch=3 must be divisible by the mesh 'data' axis size 2")
        assert rank['mesh'][1] == {'data': 2, 'tile': 1}
    assert [r['mesh'][3] for r in job['ranks']] == [0, 1]
