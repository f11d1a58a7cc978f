"""Trainer checkpoint and resume in the port: a restored run continues as
the straight run does, bit for bit.

The port's form of tests/test_resume.py (phase 0, densification off, one
32x32 view, a fresh trainer restores the file and runs on), compared for
equality where the JAX test allows 1e-6. Then a resume past a
densification step that grows a scene with no free slot: the file is
written after the growth and restored into a trainer built at the old
capacity, then runs through phase 1 (the decode's noise from the device
generator) and a second densification step (the surgery's numpy
generator). Every model leaf, Adam's moments and count, the densify
statistics and the three generators' states must equal the straight
run's.
"""
import numpy as np
import torch

from bloomscene_tpu_torch.config import GSConfig
from bloomscene_tpu_torch.models.anchors import voxelize_points
from bloomscene_tpu_torch.models.model import init_model
from bloomscene_tpu_torch.scene.cameras import camera_from_rt
from bloomscene_tpu_torch.train.loop import Trainer

torch.set_num_threads(2)
SIZE = 32


def setup(cfg: GSConfig, n_points: int = 300, seed: int = 0,
          no_free_slot: bool = False):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.8, 0.8, (n_points, 3)).astype(np.float32)
    pts[:, 2] += 2.5
    capacity = (voxelize_points(pts, cfg.voxel_size).shape[0]
                if no_free_slot else None)
    model, vs = init_model(seed, pts, cfg, capacity=capacity, device='cpu')
    cam = camera_from_rt(np.eye(3), np.zeros(3), 1.0, 1.0, SIZE, SIZE)
    img = torch.from_numpy(rng.uniform(0, 1, (SIZE, SIZE, 3)).astype(
        np.float32))
    views = [(cam.device_arrays('cpu'), img, torch.zeros((SIZE, SIZE)))]
    return model, vs, cam, views


def fresh(model):
    """An independent copy of an untrained model (trainers train the
    leaves they are given in place)."""
    from bloomscene_tpu_torch.convert import model_to
    return model_to(model, 'cpu')


def assert_same_trainer(a: Trainer, b: Trainer):
    assert a.step == b.step
    sa, sb = a.model.state.flat_leaves(), b.model.state.flat_leaves()
    for f in sa:
        torch.testing.assert_close(sa[f], sb[f], rtol=0, atol=0, msg=f)
    for (n, p), (_, q) in zip(a.model.heads.named_parameters(),
                              b.model.heads.named_parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=n)
    for k in a.model.grid:
        torch.testing.assert_close(a.model.grid[k], b.model.grid[k],
                                   rtol=0, atol=0, msg=k)
    for x, y in zip(a.model.bounds, b.model.bounds):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    oa, ob = a.optimizer.state_arrays(), b.optimizer.state_arrays()
    assert oa.keys() == ob.keys()
    for k in oa:
        np.testing.assert_array_equal(oa[k], ob[k], err_msg=k)
    # the optimizer holds the live leaves of the restored model
    live = [t for _, _, t in b.optimizer.params]
    from bloomscene_tpu_torch.train.optim import param_groups
    assert all(x is y for x, (_, _, y) in zip(live, param_groups(b.model)))
    for x, y in zip(a.stats, b.stats):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert torch.equal(a.noise_gen.get_state(), b.noise_gen.get_state())
    assert a.rng.bit_generator.state == b.rng.bit_generator.state
    assert (a.densify_rng.bit_generator.state
            == b.densify_rng.bit_generator.state)


def test_save_restore_resume_matches_straight_run(tmp_path):
    cfg = GSConfig(voxel_size=0.1, iterations=12, start_stat=10 ** 9,
                   update_from=10 ** 9, noise_from_step=10 ** 9,
                   context_from_step=10 ** 9, max_splats_per_tile=256)
    model, vs, cam, views = setup(cfg)
    tr_a = Trainer(fresh(model), cfg, cam.intrinsics, vs, seed=7,
                   device='cpu')
    tr_a.run(views, iterations=12, log_every=12)

    tr_b = Trainer(fresh(model), cfg, cam.intrinsics, vs, seed=7,
                   device='cpu')
    tr_b.run(views, iterations=6, log_every=6)
    ck = str(tmp_path / "trainer.npz")
    tr_b.save(ck)

    tr_c = Trainer(fresh(model), cfg, cam.intrinsics, vs, seed=7,
                   device='cpu')
    tr_c.restore(ck)
    assert tr_c.step == 6
    tr_c.run(views, iterations=12, log_every=12)
    assert_same_trainer(tr_a, tr_c)
    assert tr_c.history[0]['iteration'] == 12


def test_resume_past_capacity_growth(tmp_path):
    """Densification at steps 4 and 8 of a scene with no free slot; the
    first grows the capacity, the file is written at step 6, and the
    restored run meets the second in phase 1."""
    cfg = GSConfig(voxel_size=0.1, iterations=10, start_stat=0,
                   update_from=2, update_interval=4, update_until=10,
                   noise_from_step=5, context_from_step=10 ** 9,
                   max_splats_per_tile=1024)
    model, vs, cam, views = setup(cfg, n_points=200, no_free_slot=True)
    capacity0 = model.state.capacity
    assert model.state.num_alive() == capacity0

    tr_a = Trainer(fresh(model), cfg, cam.intrinsics, vs, seed=3,
                   device='cpu')
    tr_a.run(views, iterations=10, log_every=1)
    dens = [r for r in tr_a.history if 'densify_n_new' in r]
    assert [r['iteration'] for r in dens] == [4, 8]
    assert dens[0]['densify_capacity'] > capacity0     # grown at step 4

    tr_b = Trainer(fresh(model), cfg, cam.intrinsics, vs, seed=3,
                   device='cpu')
    tr_b.run(views, iterations=6, log_every=1)
    assert tr_b.model.state.capacity > capacity0
    ck = str(tmp_path / "grown.npz")
    tr_b.save(ck)

    tr_c = Trainer(fresh(model), cfg, cam.intrinsics, vs, seed=3,
                   device='cpu')
    assert tr_c.model.state.capacity == capacity0
    tr_c.restore(ck)
    assert tr_c.model.state.capacity == tr_b.model.state.capacity
    tr_c.run(views, iterations=10, log_every=1)
    assert [r['iteration'] for r in tr_c.history
            if 'densify_n_new' in r] == [8]
    assert_same_trainer(tr_a, tr_c)
