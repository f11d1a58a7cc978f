"""The port's pipeline on the CPU: ``BloomScene`` and the CLI.

- The ``BloomScene`` flow at 32 px: generate (stub priors), train a few
  steps with a trainer checkpoint, resume from it, compress, save, render
  two orbit frames and two eval views, then ``BloomScene.load`` in the
  manner of a fresh process: the decoded anchors, features and scalings
  equal the in-memory decoded model's bit for bit (as
  tests/test_pipeline.py holds JAX); a bitstream whose context digest
  does not match is skipped with a warning and gsplat.ply serves.
- ``run.main`` with ``--device cpu --resolution 32`` writes every output
  file and a training record every ``--log_every`` steps, times each
  stage in the ``BloomScene``'s spans, ``--load_dir`` renders the saved run's decoded orbit, and an
  unknown ``--campath_render`` is refused before any work; with
  ``--device_loop`` the same run trains in device-loop chunks and writes
  the same files and records.

tests/test_torch_io.py opens a scene that the JAX package wrote.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from bloomscene_tpu_torch.config import CameraConfig, GSConfig
from bloomscene_tpu_torch.pipeline import run
from bloomscene_tpu_torch.pipeline.bloomscene import BloomScene

torch.set_num_threads(2)
TINY = dict(voxel_size=0.2, iterations=6, start_stat=2, update_from=10 ** 9,
            noise_from_step=10 ** 9, context_from_step=10 ** 9,
            max_splats_per_tile=128)
OUTPUTS = ('settings.json', 'traindata.npz', 'point_cloud.ply', 'gsplat.ply',
           'checkpoint.npz', 'bitstreams/meta.json', 'codec_sizes.json',
           'train_log.json', 'metrics.json', 'eval_renders/000.png')


@pytest.fixture
def no_clip(monkeypatch):
    """The card's machine has no transformers: CLIP fails at its import
    (here it would import its backends before failing on the weights)."""
    monkeypatch.setitem(sys.modules, 'transformers', None)


def test_bloomscene_flow_on_cpu(tmp_path, no_clip):
    cfg = GSConfig(**TINY)
    cam = CameraConfig(H=32, W=32, focal=(36.4, 36.4))
    rgb = np.random.default_rng(2).uniform(0.2, 0.8, (32, 32, 3)).astype(
        np.float32)
    out = str(tmp_path / 'out')
    bs = BloomScene(out, cfg=cfg, cam=cam, seed=0, device='cpu')
    bs.generate(rgb, 'a colorful room', diff_steps=1, verbose=False)
    assert len(bs.scene.train_cameras) == 50
    bs.training(iterations=4, log_every=2, checkpoint_every=2)
    assert os.path.exists(os.path.join(out, 'train_ckpt.meta.json'))

    # a relaunched process: the traindata cache, then the trainer file
    bs = BloomScene(out, cfg=cfg, cam=cam, seed=0, device='cpu')
    bs.generate(rgb, 'a colorful room', diff_steps=1, verbose=False)
    bs.training(log_every=2, resume=True)
    assert bs.trainer.step == 6
    assert [r['iteration'] for r in bs.logs] == [6]
    assert np.isfinite(bs.logs[-1]['loss'])

    sizes = bs.compress()
    assert sizes['total_MB'] > 0 and 'decode_split' in sizes
    bs.save_outputs()
    bs.scene = bs.scene._replace(
        preset_cameras={'rotate360': bs.scene.preset_cameras['rotate360'][:2]},
        eval_cameras=bs.scene.eval_cameras[:2])
    assert bs.render_video('rotate360')['n_frames'] == 2
    ev = bs.render_eval('a colorful room')
    assert np.isfinite(ev['proxy_sharpness']) and not ev['available']
    assert np.isnan(ev['clip_score'])
    for f in OUTPUTS[1:]:
        assert os.path.exists(os.path.join(out, f)), f

    bs2 = BloomScene.load(out, cfg=cfg, device='cpu')
    assert bs2.scene is not None
    for f in ('anchor', 'feat', 'scaling_log', 'offset', 'mask_logit'):
        torch.testing.assert_close(getattr(bs2.decoded_model.state, f),
                                   getattr(bs.decoded_model.state, f),
                                   rtol=0, atol=0, msg=f)
    # the eval model comes from gsplat.ply: the trained model's alive rows
    alive = bs.model.state.alive
    n = int(alive.sum())
    torch.testing.assert_close(bs2.model.state.feat[:n],
                               bs.model.state.feat[alive].detach(),
                               rtol=0, atol=0)
    bs2.scene = bs2.scene._replace(preset_cameras={
        'rotate360': bs2.scene.preset_cameras['rotate360'][:2]})
    assert bs2.render_video('rotate360', use_decoded=True)['n_frames'] == 2

    # a bitstream whose context digest does not match (as one the other
    # package encoded): skipped with a warning, gsplat.ply serves
    meta_path = os.path.join(out, 'bitstreams', 'meta.json')
    with open(meta_path) as f:
        meta = json.load(f)
    meta['context_sha256'] = '0' * 64
    with open(meta_path, 'w') as f:
        json.dump(meta, f)
    with pytest.warns(UserWarning, match='skipping bitstream decode'):
        bs3 = BloomScene.load(out, cfg=cfg, device='cpu')
    assert bs3.decoded_model is None
    torch.testing.assert_close(bs3.model.state.feat, bs2.model.state.feat,
                               rtol=0, atol=0)


def test_cli_main_then_load_dir(tmp_path, no_clip):
    out = str(tmp_path / 'run')
    argv = ['--priors', 'stub', '--resolution', '32', '--voxel_size', '0.5',
            '--iterations', '3', '--render_frames', '2',
            '--max_splats_per_tile', '64', '--n_features', '1', '--log2',
            '10', '--log2_2D', '10', '--dep_value', '--dep_domin',
            '--dep_smooth', '--device', 'cpu', '--log_every', '2',
            '--save_dir', out]
    bs = run.main(argv)
    for f in OUTPUTS + ('eval_renders/049.png',):
        assert os.path.exists(os.path.join(out, f)), f
    for video in ('rotate360', 'rotate360_depth'):
        assert (os.path.exists(os.path.join(out, video + '.mp4'))
                or os.path.exists(os.path.join(out, video, '0000.png')))
    with open(os.path.join(out, 'settings.json')) as f:
        settings = json.load(f)
    assert settings['device'] == 'cpu' and settings['resolution'] == 32
    assert bs.cfg.use_dpr and bs.cfg.max_splats_per_tile == 64
    assert bs.cfg.n_features_per_level == 1
    assert bs.trainer.step == 3
    # a record every --log_every steps and at the last
    assert [r['iteration'] for r in bs.logs] == [2, 3]
    with open(os.path.join(out, 'train_log.json')) as f:
        assert [r['iteration'] for r in json.load(f)] == [2, 3]
    # each stage timed once in the BloomScene's spans
    spans = bs.spans.summary()
    assert {k: v['count'] for k, v in spans.items()} == {
        'generate': 1, 'training': 1, 'compress': 1, 'save_outputs': 1,
        'render_video': 1, 'render_eval': 1}
    assert all(v['total_s'] > 0 for v in spans.values())

    # the widths come from the run's settings.json
    bs2 = run.main(['--load_dir', out, '--device', 'cpu', '--render_frames',
                    '2'])
    assert bs2.cfg == bs.cfg
    torch.testing.assert_close(bs2.decoded_model.state.anchor,
                               bs.decoded_model.state.anchor, rtol=0, atol=0)


def test_cli_refusals(tmp_path, no_clip):
    out = str(tmp_path / 'never')
    with pytest.raises(SystemExit, match='unknown --campath_render'):
        run.main(['--campath_render', 'spiral', '--device', 'cpu',
                  '--save_dir', out])
    assert not os.path.exists(out)
    # --device_loop trains (in device-loop chunks; eagerly on the CPU)
    out = str(tmp_path / 'device_loop')
    bs = run.main(['--priors', 'stub', '--resolution', '32', '--voxel_size',
                   '0.5', '--iterations', '3', '--render_frames', '2',
                   '--max_splats_per_tile', '64', '--n_features', '1',
                   '--log2', '10', '--log2_2D', '10', '--dep_value',
                   '--dep_domin', '--dep_smooth', '--device', 'cpu',
                   '--log_every', '2', '--device_loop', '--device_loop_chunk',
                   '2', '--save_dir', out])
    for f in OUTPUTS + ('eval_renders/049.png',):
        assert os.path.exists(os.path.join(out, f)), f
    assert bs.cfg.device_loop and bs.cfg.device_loop_chunk == 2
    assert bs.trainer.step == 3
    assert [r['iteration'] for r in bs.logs] == [2, 3]
    with open(os.path.join(out, 'train_log.json')) as f:
        assert [r['iteration'] for r in json.load(f)] == [2, 3]
