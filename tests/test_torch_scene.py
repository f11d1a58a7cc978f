"""Port parity: the scene layer and point-cloud generation, bitwise.

The port's host code (numpy and scipy, as the JAX package's) against the
JAX package on the same seeded inputs, compared for equality:

- the trajectories: ``seed_360`` (plain and shuffled), ``seed_hemisphere``,
  ``get_pcd_gen_poses``, ``get_camera_paths``, ``write_rotate360_json``;
- ``apply_pose_noise`` on the recorded fixture's cameras;
- ``read_scene_data`` on tests/fixtures/traindata_stub_64.npz, with and
  without a ``preset_json``: view matrices, intrinsics, ``radius``,
  ``translate``, points and colors, the noisy eval cameras, the presets;
- the stub priors, and ``generate_pcd`` at 32 px (a non-square input, so
  the outpaint path and the resize run): every ``traindata`` array;
- ``traindata.npz`` written by the port and read by JAX's
  ``_load_traindata``;
- the real-prior adapters' call contract against mocked backends (their
  weights are not here), as tests/test_priors.py holds JAX's.
"""
import json
import os
import sys
import types

import numpy as np
import pytest

from bloomscene_tpu.config import CameraConfig as JaxCameraConfig
from bloomscene_tpu.pipeline import bloomscene as jax_bloomscene
from bloomscene_tpu.pipeline import pcdgen as jax_pcdgen
from bloomscene_tpu.priors import StubDepthPrior as JaxStubDepth
from bloomscene_tpu.priors import StubInpaintPrior as JaxStubInpaint
from bloomscene_tpu.scene import dataset as jax_dataset
from bloomscene_tpu.scene import pose_noise as jax_pose_noise
from bloomscene_tpu.scene import trajectory as jax_trajectory
from bloomscene_tpu_torch.config import CameraConfig
from bloomscene_tpu_torch.pipeline import bloomscene, pcdgen
from bloomscene_tpu_torch.priors import StubDepthPrior, StubInpaintPrior
from bloomscene_tpu_torch.scene import dataset, pose_noise, trajectory

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       'fixtures', 'traindata_stub_64.npz')


def test_trajectories_match_jax(tmp_path):
    for shuffled in (False, True):
        np.testing.assert_array_equal(
            trajectory.seed_360(360, 10, shuffled=shuffled),
            jax_trajectory.seed_360(360, 10, shuffled=shuffled))
    depths = [2.1, 2.6, 3.3]
    np.testing.assert_array_equal(trajectory.seed_hemisphere(depths, 7.0),
                                  jax_trajectory.seed_hemisphere(depths, 7.0))
    np.testing.assert_array_equal(
        trajectory.get_pcd_gen_poses('rotate360'),
        jax_trajectory.get_pcd_gen_poses('rotate360'))
    np.testing.assert_array_equal(
        trajectory.get_pcd_gen_poses('hemisphere', depths),
        jax_trajectory.get_pcd_gen_poses('hemisphere', depths))
    with pytest.raises(ValueError):
        trajectory.get_pcd_gen_poses('spiral')
    assert trajectory.get_camera_paths(37) == jax_trajectory.get_camera_paths(
        37)
    a = trajectory.write_rotate360_json(str(tmp_path / 'a.json'), 24)
    b = jax_trajectory.write_rotate360_json(str(tmp_path / 'b.json'), 24)
    assert a == b
    with open(tmp_path / 'a.json') as fa, open(tmp_path / 'b.json') as fb:
        assert fa.read() == fb.read()


@pytest.fixture(scope='module')
def traindata():
    return jax_bloomscene._load_traindata(FIXTURE)


def assert_same_cameras(tc, jc):
    assert len(tc) == len(jc)
    for a, b in zip(tc, jc):
        assert (a.width, a.height, a.fovx, a.fovy, a.name) == (
            b.width, b.height, b.fovx, b.fovy, b.name)
        np.testing.assert_array_equal(a.viewmat, b.viewmat)
        for x, y in ((a.image, b.image), (a.depth, b.depth)):
            if y is None:
                assert x is None
            else:
                np.testing.assert_array_equal(x, y)


def test_apply_pose_noise_matches_jax(traindata):
    td = bloomscene._load_traindata(FIXTURE)
    tcams = dataset.read_scene_data(td, with_eval_noise=False).train_cameras
    jcams = jax_dataset.read_scene_data(traindata,
                                        with_eval_noise=False).train_cameras
    for kw in ({}, {'chunk_size': 7, 'r_max': 3.0, 't_max': 0.1,
                    'seed': 5}):
        assert_same_cameras(pose_noise.apply_pose_noise(tcams, **kw),
                            jax_pose_noise.apply_pose_noise(jcams, **kw))


@pytest.mark.parametrize('with_json', [False, True])
def test_read_scene_data_matches_jax(tmp_path, traindata, with_json):
    preset = None
    if with_json:
        frames = trajectory.get_camera_paths(12)['rotate360']['frames']
        path = str(tmp_path / 'orbit.json')
        with open(path, 'w') as f:
            json.dump({'camera_angle_x': 0.9, 'frames': frames}, f)
        preset = {'orbit': path}
    td = bloomscene._load_traindata(FIXTURE)
    t = dataset.read_scene_data(td, preset_json=preset)
    j = jax_dataset.read_scene_data(traindata, preset_json=preset)
    np.testing.assert_array_equal(t.points, j.points)
    np.testing.assert_array_equal(t.colors, j.colors)
    np.testing.assert_array_equal(t.translate, j.translate)
    assert t.radius == j.radius
    assert_same_cameras(t.train_cameras, j.train_cameras)
    assert_same_cameras(t.eval_cameras, j.eval_cameras)
    assert t.preset_cameras.keys() == j.preset_cameras.keys()
    for k in t.preset_cameras:
        assert_same_cameras(t.preset_cameras[k], j.preset_cameras[k])
    assert t.train_cameras[0].intrinsics.__dict__ == \
        j.train_cameras[0].intrinsics.__dict__
    if with_json:
        assert abs(t.preset_cameras['orbit'][0].fovx - 0.9) < 1e-12
    else:
        assert t.preset_cameras['rotate360'][0].fovx == \
            traindata['camera_angle_x'] * 0.95


def test_stub_priors_match_jax():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (48, 40, 3)).astype(np.float32)
    mask = np.zeros((48, 40), np.float32)
    mask[10:30, 5:25] = 1
    for m in (mask, mask[..., None], np.zeros_like(mask)):
        np.testing.assert_array_equal(
            StubInpaintPrior()(img, m, 'p', seed=3),
            JaxStubInpaint()(img, m, 'p', seed=3))
    np.testing.assert_array_equal(StubDepthPrior()(img),
                                  JaxStubDepth()(img))


def test_generate_pcd_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    rgb = rng.uniform(0, 1, (48, 40, 3)).astype(np.float32)   # outpainted
    args = (rgb, 'a room', '', 'rotate360', 0, 2)
    t = pcdgen.generate_pcd(
        *args, CameraConfig(H=32, W=32, focal=(36.4, 36.4)),
        StubInpaintPrior(), StubDepthPrior(),
        save_ply_path=str(tmp_path / 't.ply'))
    j = jax_pcdgen.generate_pcd(
        *args, JaxCameraConfig(H=32, W=32, focal=(36.4, 36.4)),
        JaxStubInpaint(), JaxStubDepth(),
        save_ply_path=str(tmp_path / 'j.ply'))
    assert (t['camera_angle_x'], t['W'], t['H']) == (
        j['camera_angle_x'], j['W'], j['H'])
    for k in ('pcd_points', 'pcd_colors'):
        assert t[k].dtype == j[k].dtype
        np.testing.assert_array_equal(t[k], j[k])
    assert len(t['frames']) == len(j['frames']) == 50
    for a, b in zip(t['frames'], j['frames']):
        assert a['transform_matrix'] == b['transform_matrix']
        for k in ('image', 'depth'):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    with open(tmp_path / 't.ply', 'rb') as a, open(tmp_path / 'j.ply',
                                                   'rb') as b:
        assert a.read() == b.read()

    # the port's traindata.npz, read by the JAX package
    path = str(tmp_path / 'traindata.npz')
    bloomscene._save_traindata(path, t)
    back = jax_bloomscene._load_traindata(path)
    for k in ('camera_angle_x', 'W', 'H'):
        assert back[k] == t[k]
    for k in ('pcd_points', 'pcd_colors'):
        np.testing.assert_array_equal(back[k], t[k])
    for a, b in zip(back['frames'], t['frames']):
        np.testing.assert_array_equal(a['image'], b['image'])
        np.testing.assert_array_equal(a['depth'], b['depth'])
        assert a['transform_matrix'] == b['transform_matrix']


# ---------------- real-prior adapters (mocked backends) ----------------

def test_diffusers_adapter_contract(monkeypatch):
    import torch
    from PIL import Image
    calls = {}

    class FakePipe:
        scheduler = types.SimpleNamespace(config={'beta': 1})
        device = torch.device('cpu')

        def to(self, device):
            calls['device'] = device
            return self

        def __call__(self, prompt, negative_prompt, image, mask_image,
                     generator, num_inference_steps):
            calls.update(prompt=prompt, neg=negative_prompt,
                         steps=num_inference_steps, size=image.size,
                         mode_mask=mask_image.mode)
            arr = (np.asarray(image, np.float32) * 0.5).astype(np.uint8)
            return types.SimpleNamespace(images=[Image.fromarray(arr)])

    fake = types.ModuleType('diffusers')
    fake.StableDiffusionInpaintPipeline = types.SimpleNamespace(
        from_pretrained=lambda model_id, torch_dtype: (
            calls.update(model_id=model_id, dtype=torch_dtype),
            FakePipe())[1])
    fake.DDIMScheduler = types.SimpleNamespace(
        from_config=lambda config: ('ddim', config))
    monkeypatch.setitem(sys.modules, 'diffusers', fake)

    from bloomscene_tpu_torch.priors import DiffusersInpaintPrior
    prior = DiffusersInpaintPrior()
    assert calls['device'] == 'cuda' and calls['dtype'] == torch.float16
    prior = DiffusersInpaintPrior(device='cpu')
    assert calls['model_id'].endswith('stable-diffusion-2-inpainting')
    assert calls['dtype'] == torch.float32
    assert prior.pipe.scheduler[0] == 'ddim'
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (64, 64, 3)).astype(np.float32)
    mask = np.zeros((64, 64, 3), np.float32)
    mask[10:30, 10:30] = 1
    out = prior(img, mask, 'a room', 'ugly', seed=3, num_steps=7)
    assert calls['prompt'] == 'a room' and calls['neg'] == 'ugly'
    assert calls['steps'] == 7 and calls['size'] == (64, 64)
    assert calls['mode_mask'] == 'L'
    assert out.shape == (64, 64, 3) and out.dtype == np.float32
    assert 0.0 <= out.min() and out.max() <= 1.0


def test_zoedepth_adapter_contract(monkeypatch):
    import torch
    seen = {}

    class FakeZoe:
        def to(self, device):
            seen['device'] = device
            return self

        def eval(self):
            return self

        def infer_pil(self, im):
            w, h = im.size
            return np.full((h, w), 2.5, np.float32)

    def fake_hub_load(repo, name, pretrained):
        assert repo == 'isl-org/ZoeDepth' and name == 'ZoeD_N' and pretrained
        return FakeZoe()

    monkeypatch.setattr(torch.hub, 'load', fake_hub_load)
    from bloomscene_tpu_torch.priors import ZoeDepthPrior
    prior = ZoeDepthPrior()
    assert seen['device'] == 'cuda'
    d = prior(np.zeros((48, 32, 3), np.float32))
    assert d.shape == (48, 32) and d.dtype == np.float32
