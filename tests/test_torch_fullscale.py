"""``bloomscene_tpu_torch.run_fullscale`` on the CPU, at 32 px.

- ``run`` with a cut schedule (and narrow widths) crosses training phases
  0 -> 1 -> 2 and two ``adjust_anchor`` steps in the device loop with a
  compacted decode; its
  record holds every key of the JAX script's record (RUN_r05.json), the
  re-encode is byte-exact, no logged step dropped a splat, and the port's
  own keys (step ms by phase, chunks, launches, stages) are there.
- ``main`` without ``--device cpu`` raises where CUDA is absent.
"""
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from bloomscene_tpu_torch import run_fullscale

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# GSConfig's step numbers cut so that 9 steps cross phase 1 (4-6), the
# bounds refresh (6) and phase 2 (7-9), with adjust_anchor at steps 3 and 6
CUT = dict(noise_from_step=3, context_from_step=6, start_stat=0,
           update_from=2, update_interval=3, update_until=8,
           densify_pause_from=10 ** 9, densify_pause_until=10 ** 9,
           max_splats_per_tile=512, feat_dim=16, n_offsets=4,
           n_features_per_level=1, resolutions_3d=(18, 24, 33),
           log2_hashmap_size_3d=10, resolutions_2d=(130,),
           log2_hashmap_size_2d=10)
ITERATIONS = 9


@pytest.fixture
def no_clip(monkeypatch):
    """The card's machine has no transformers: CLIP fails at its import."""
    monkeypatch.setitem(sys.modules, 'transformers', None)


def test_run_fullscale_cut_schedule(tmp_path, no_clip):
    out = str(tmp_path / 'record.json')
    args = run_fullscale.build_parser().parse_args([
        '--resolution', '32', '--iterations', str(ITERATIONS),
        '--voxel_size', '0.5', '--visible_capacity', '256',
        '--render_frames', '2', '--device', 'cpu',
        '--save_dir', str(tmp_path / 'run'), '--out', out])
    cfg = dataclasses.replace(run_fullscale.config(args), **CUT)
    rec, bs = run_fullscale.run(args, cfg)
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(rec))
    with open(os.path.join(REPO, 'RUN_r05.json')) as f:
        jax_rec = json.load(f)
    assert not set(jax_rec) - set(rec)
    for key in ('codec_split', 'codec_postfix', 'trainview_psnr_50view_mean',
                'video', 'proxy_iqa'):
        assert not set(jax_rec[key]) - set(rec[key]), key
    assert rec['reencode_bit_exact'] is True
    assert rec['device'] == 'cpu' and rec['n_train_views'] == 50
    assert bs.model.state.capacity > cfg.visible_capacity   # compacted
    assert rec['quality']['logged_steps_with_overflow'] == 0
    assert rec['quality']['trainview_frames_with_overflow'] == 0
    assert all(v == 0 for v in rec['quality']['overflow_max'].values())
    assert np.isfinite(rec['final_loss'])
    assert rec['video']['n_frames'] == 2

    # the device loop crossed every phase and both surgeries
    chunks = rec['chunks']
    assert chunks[0]['first'] == 1 and chunks[-1]['last'] == ITERATIONS
    assert [c['last'] for c in chunks if c['surgery']] == [3, 6]
    by_phase = rec['step_ms_by_phase']
    assert [by_phase[p]['steps'] for p in (0, 1, 2)] == [3, 3, 3]
    assert all(by_phase[p]['wall_ms'] > 0 for p in (0, 1, 2))
    assert rec['resumed_from_step'] == 0
    # no graphs on the CPU: every step eager, each kernel's plain version
    assert rec['graphs']['captures'] == 0 and rec['eager_steps'] == 9
    assert set(rec['launches']) == {'pair_expansion', 'slab_expansion',
                                     'blend_forward', 'blend_backward',
                                     'hashgrid_bwd', 'gather_rows_bwd',
                                     'hashgrid_encode', 'hashgrid_encode_bwd',
                                     'stamp', 'emission_sums'}
    # every chunk carries its stamps' span times and its host spans (only
    # the run's last chunk logs a step at log_every 100, and waits for its
    # records); the phase-2 decode's context and rate spans, and the
    # surgeries' spans
    for c in chunks:
        assert c['stamped_steps'] == c['last'] - c['first'] + 1
        assert c['span_ms'] and c['step_gap_ms'] >= 0
        assert {'loop.scalars', 'loop.eager'} <= set(c['host_ms'])
        assert ('loop.wait' in c['host_ms']) == (c['last'] == ITERATIONS)
    assert any(p.endswith('render.decode/decode.context')
               for c in chunks if c['phase'] == 2 for p in c['span_ms'])
    assert all('loop.surgery' in c['host_ms'] for c in chunks
               if c['surgery'])
    assert {'generate', 'training', 'compress', 'save_outputs',
            'render_video', 'render_eval'} <= set(rec['stages'])


def test_main_needs_cuda_unless_asked_for_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('CUDA is available here')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        run_fullscale.main(['--save_dir', str(tmp_path / 'run'),
                            '--out', str(tmp_path / 'r.json')])
    assert not os.path.exists(tmp_path / 'r.json')
