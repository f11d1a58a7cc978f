"""Port parity: the files and images of the pipeline.

- ``utils/image.py``: ``read_png`` equals PIL's decode of the example PNGs
  and of PNGs written here with each of the five row filters;
  ``write_png`` round-trips through PIL and itself; ``resize`` equals
  PIL's ``Image.resize`` (bicubic) bit for bit at 512 -> 256, 512 -> 32, a
  non-square crop and an enlargement, and is the identity at equal size.
- ``utils/io.py``: the point-cloud and anchor PLYs are byte for byte the
  JAX package's for the same points and the same (converted) state, and
  each package reads the other's; ``checkpoint.npz`` written by JAX loads
  into the port equal to ``model_from_jax_params`` leaf for leaf, and the
  port's file loads into JAX equal to the JAX model, bitwise;
  ``write_video`` falls back to PNG frames without imageio.
- A JAX model written by JAX's ``save_anchor_ply`` and ``save_checkpoint``
  beside the recorded traindata fixture opens in the port's
  ``BloomScene.load``: its model equals ``model_from_jax_params`` of the
  model JAX's own ``BloomScene.load`` gives, bitwise, and one eval frame
  at 64 px matches JAX's ``render`` within tests/test_torch_render.py's
  tolerances.
- ``colorize``, ``proxy_iqa`` and ``psnr`` equal the JAX package's;
  ``RunLogger``, ``Spans`` and ``trace`` record what they are given.
"""
import glob
import json
import os
import shutil
import struct
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from bloomscene_tpu.config import GSConfig as JaxConfig
from bloomscene_tpu.models.model import init_model as jax_init_model
from bloomscene_tpu.models.render import render as jax_render
from bloomscene_tpu.ops.pallas import blend as pallas_blend
from bloomscene_tpu.pipeline.bloomscene import BloomScene as JaxBloomScene
from bloomscene_tpu.utils import depthviz as jax_depthviz
from bloomscene_tpu.utils import io as jax_io
from bloomscene_tpu.utils import metrics as jax_metrics
from bloomscene_tpu_torch.config import GSConfig
from bloomscene_tpu_torch.convert import model_from_jax_params
from bloomscene_tpu_torch.models.render import render
from bloomscene_tpu_torch.pipeline.bloomscene import BloomScene
from bloomscene_tpu_torch.utils import depthviz, image, io, metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, 'tests', 'fixtures', 'traindata_stub_64.npz')
EXAMPLES = sorted(glob.glob(os.path.join(REPO, 'examples', '*.png')))
# a narrow model, with and without the optional feature-bank head (whose
# name sorts between 'deform' and 'grid' in the checkpoint's leaf order)
NARROW = dict(feat_dim=8, n_offsets=3, resolutions_3d=(18, 24),
              log2_hashmap_size_3d=8, resolutions_2d=(34,),
              log2_hashmap_size_2d=8, voxel_size=0.1)
CONFIGS = {'mlp': NARROW,
           'feature_bank_sh': dict(NARROW, use_feat_bank=True,
                                   color_mode='sh', sh_degree=2)}


# ---------------- PNG ----------------

@pytest.mark.parametrize('path', EXAMPLES, ids=os.path.basename)
def test_read_png_matches_pil(path):
    np.testing.assert_array_equal(image.read_png(path),
                                  np.asarray(Image.open(path)))


def _filtered_png(img: np.ndarray, kind: int) -> bytes:
    """A PNG of uint8 ``img`` [H, W, C] whose every row uses filter
    ``kind`` (the encoder's side of the PNG specification, written out)."""
    h, w, ch = img.shape
    rows = img.reshape(h, w * ch).astype(np.int64)
    out = []
    prev = np.zeros(w * ch, np.int64)
    for y in range(h):
        x = rows[y]
        a = np.concatenate([np.zeros(ch, np.int64), x[:-ch]])
        c = np.concatenate([np.zeros(ch, np.int64), prev[:-ch]])
        b = prev
        if kind == 0:
            pred = np.zeros_like(x)
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = b
        elif kind == 3:
            pred = (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, b, c))
        out.append(bytes([kind]) + ((x - pred) & 0xFF).astype(
            np.uint8).tobytes())
        prev = x
    color = {1: 0, 3: 2, 4: 6}[ch]

    def chunk(t, body):
        return (struct.pack('>I', len(body)) + t + body
                + struct.pack('>I', zlib.crc32(t + body) & 0xFFFFFFFF))
    return (b'\x89PNG\r\n\x1a\n'
            + chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, color, 0, 0,
                                         0))
            + chunk(b'IDAT', zlib.compress(b''.join(out)))
            + chunk(b'IEND', b''))


@pytest.mark.parametrize('channels', [1, 3, 4])
@pytest.mark.parametrize('kind', range(5))
def test_read_png_row_filters(tmp_path, kind, channels):
    img = np.random.default_rng(kind).integers(
        0, 256, (9, 13, channels)).astype(np.uint8)
    path = str(tmp_path / 'f.png')
    with open(path, 'wb') as f:
        f.write(_filtered_png(img, kind))
    want = img[..., 0] if channels == 1 else img
    np.testing.assert_array_equal(np.asarray(Image.open(path)), want)
    np.testing.assert_array_equal(image.read_png(path), want)


@pytest.mark.parametrize('shape', [(17, 11), (17, 11, 3), (17, 11, 4)])
def test_write_png_round_trips(tmp_path, shape):
    img = np.random.default_rng(1).integers(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / 'w.png')
    image.write_png(path, img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(image.read_png(path), img)


def test_read_png_refuses_other_kinds(tmp_path):
    path = str(tmp_path / 'p.png')
    Image.fromarray(np.zeros((4, 4), np.uint8)).convert('P').save(path)
    with pytest.raises(ValueError, match='unsupported PNG'):
        image.read_png(path)


# ---------------- resize ----------------

@pytest.mark.parametrize('size,crop', [
    ((256, 256), None), ((32, 32), None), ((300, 200), (400, 512)),
    ((700, 600), None)], ids=['512to256', '512to32', 'crop', 'enlarge'])
def test_resize_matches_pil(size, crop):
    src = image.read_png(EXAMPLES[0])
    if crop is not None:
        src = np.ascontiguousarray(src[:crop[0], :crop[1]])
    got = image.resize(src, size)
    want = np.asarray(Image.fromarray(src).resize((size[1], size[0])))
    np.testing.assert_array_equal(got, want)
    gray = np.ascontiguousarray(src[..., 1])
    np.testing.assert_array_equal(
        image.resize(gray, size),
        np.asarray(Image.fromarray(gray).resize((size[1], size[0]))))


def test_resize_identity_at_equal_size():
    src = image.read_png(EXAMPLES[0])
    out = image.resize(src, src.shape[:2])
    np.testing.assert_array_equal(out, src)
    assert out is not src


# ---------------- PLY and checkpoint ----------------

def points(n=400, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.normal(0, 1, (n, 3)).astype(np.float32)
    pts[:, 2] += 3.0
    return pts, rng.uniform(0, 1, (n, 3)).astype(np.float32)


@pytest.mark.parametrize('with_colors', [True, False])
def test_point_cloud_ply_bytes_match_jax(tmp_path, with_colors):
    pts, cols = points()
    cols = cols if with_colors else None
    jp, tp = str(tmp_path / 'j.ply'), str(tmp_path / 't.ply')
    jax_io.save_ply_pointcloud(jp, pts, cols)
    io.save_ply_pointcloud(tp, pts, cols)
    with open(jp, 'rb') as a, open(tp, 'rb') as b:
        assert a.read() == b.read()
    for (p1, c1), (p2, c2) in ((io.load_ply_pointcloud(jp),
                                jax_io.load_ply_pointcloud(tp)),):
        np.testing.assert_array_equal(p1, p2)
        if with_colors:
            np.testing.assert_array_equal(c1, c2)
        else:
            assert c1 is None and c2 is None


def jax_model(cfg_kw, seed=0):
    """A JAX model whose features and offsets are seeded (zero at init),
    with numpy leaves, and its port twin on the CPU."""
    pts, _ = points()
    m, _ = jax_init_model(jax.random.PRNGKey(seed), pts,
                          JaxConfig(**cfg_kw))
    rng = np.random.default_rng(seed)
    C = m.state.capacity
    st = m.state._replace(
        feat=jnp.asarray(rng.normal(0, 1, (C, cfg_kw['feat_dim'])).astype(
            np.float32)),
        offset=jnp.asarray(rng.normal(0, 0.3, (C, cfg_kw['n_offsets'], 3))
                           .astype(np.float32)))
    m = jax.tree.map(np.asarray, m._replace(state=st))
    return m, model_from_jax_params(m, GSConfig(**cfg_kw), device='cpu')


def test_anchor_ply_bytes_match_jax(tmp_path):
    m, tm = jax_model(NARROW)
    jp, tp = str(tmp_path / 'j.ply'), str(tmp_path / 't.ply')
    jax_io.save_anchor_ply(jp, m.state)
    io.save_anchor_ply(tp, tm.state)
    with open(jp, 'rb') as a, open(tp, 'rb') as b:
        assert a.read() == b.read()
    js = jax_io.load_anchor_ply(tp, NARROW['n_offsets'], NARROW['feat_dim'])
    ts = io.load_anchor_ply(jp, NARROW['n_offsets'], NARROW['feat_dim'],
                            device='cpu')
    n = int(np.asarray(m.state.alive).sum())
    assert ts.capacity == js.capacity == max(
        64, int(2 ** np.ceil(np.log2(1.5 * n))))
    for f, v in ts.flat_leaves().items():
        np.testing.assert_array_equal(v.numpy(),
                                      np.asarray(getattr(js, '_' + f)),
                                      err_msg=f)


@pytest.mark.parametrize('name', list(CONFIGS))
def test_checkpoint_crosses_packages(tmp_path, name):
    cfg_kw = CONFIGS[name]
    m, tm = jax_model(cfg_kw)
    like_j = {'heads': m.heads, 'grid': m.grid, 'bounds': m.bounds}
    # JAX writes, the port reads: model_from_jax_params leaf for leaf
    jp = str(tmp_path / 'j.npz')
    jax_io.save_checkpoint(jp, like_j)
    shell, _ = jax_model(cfg_kw, seed=1)
    shell = model_from_jax_params(shell, GSConfig(**cfg_kw), device='cpu')
    got = io.load_checkpoint(jp, shell)
    for (n1, a, _), (n2, b, _) in zip(
            io.checkpoint_leaves(got.heads, got.grid, got.bounds),
            io.checkpoint_leaves(tm.heads, tm.grid, tm.bounds)):
        assert n1 == n2
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n1)
    assert got.state is shell.state
    # the port writes, JAX reads: the JAX model's leaves
    tp = str(tmp_path / 't.npz')
    io.save_checkpoint(tp, tm)
    back = jax_io.load_checkpoint(tp, like_j)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(like_j)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a), b)
    with np.load(jp) as zj, np.load(tp) as zt:
        assert ({k for k in zj.files if k.startswith('leaf_')}
                == {k for k in zt.files if k.startswith('leaf_')})


def test_write_video_png_frames_without_imageio(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, 'imageio', None)
    frames = [np.random.default_rng(i).uniform(0, 1, (8, 6, 3))
              for i in range(3)]
    assert io.write_video(str(tmp_path / 'v.mp4'), frames)
    for i, fr in enumerate(frames):
        got = image.read_png(str(tmp_path / 'v' / f'{i:04d}.png'))
        np.testing.assert_array_equal(got, (np.clip(fr, 0, 1) * 255).astype(
            np.uint8))


SERVED = dict(feat_dim=16, n_offsets=4, resolutions_3d=(18, 24, 33),
              log2_hashmap_size_3d=10, resolutions_2d=(130,),
              log2_hashmap_size_2d=10, voxel_size=0.08,
              max_splats_per_tile=256)


def test_jax_scene_served_by_port(tmp_path):
    """JAX writes gsplat.ply and checkpoint.npz (no bitstreams) beside the
    fixture's traindata.npz; the port loads and renders them."""
    out = str(tmp_path / 'jax_run')
    os.makedirs(out)
    shutil.copy(FIXTURE, os.path.join(out, 'traindata.npz'))
    jcfg = JaxConfig(**SERVED)
    pts = np.load(FIXTURE)['pcd_points'].astype(np.float32).T
    m, _ = jax_init_model(jax.random.PRNGKey(3), pts, jcfg)
    rng = np.random.default_rng(3)
    C = m.state.capacity
    m = m._replace(state=m.state._replace(
        feat=jnp.asarray(rng.normal(0, 1, (C, 16)).astype(np.float32)),
        offset=jnp.asarray(rng.normal(0, 0.02, (C, 4, 3)).astype(
            np.float32))))
    jax_io.save_anchor_ply(os.path.join(out, 'gsplat.ply'), m.state)
    jax_io.save_checkpoint(os.path.join(out, 'checkpoint.npz'),
                           {'heads': m.heads, 'grid': m.grid,
                            'bounds': m.bounds})

    jbs = JaxBloomScene.load(out, cfg=jcfg)
    want = model_from_jax_params(jax.tree.map(np.asarray, jbs.model),
                                 GSConfig(**SERVED), device='cpu')
    tbs = BloomScene.load(out, cfg=GSConfig(**SERVED), device='cpu')
    assert tbs.decoded_model is None
    got = tbs.model
    for f, v in want.state.flat_leaves().items():
        torch.testing.assert_close(got.state.flat_leaves()[f], v, rtol=0,
                                   atol=0, msg=f)
    for k in want.grid:
        torch.testing.assert_close(got.grid[k], want.grid[k], rtol=0, atol=0)
    for a, b in zip(got.bounds, want.bounds):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for (n, a), (_, b) in zip(got.heads.named_parameters(),
                              want.heads.named_parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)

    tcam = tbs.scene.eval_cameras[0]
    jcam = jbs.scene.eval_cameras[0]
    np.testing.assert_array_equal(tcam.viewmat, jcam.viewmat)
    assert tcam.width == 64
    pallas_blend.INTERPRET = True
    try:
        rj = jax.jit(lambda mm, cc: jax_render(
            mm, jcam.intrinsics, cc, jcfg, mode='eval', backend='pallas'))(
                jbs.model, jcam.device_arrays())
    finally:
        pallas_blend.INTERPRET = False
    rt = render(got, tcam.intrinsics, tcam.device_arrays('cpu'),
                GSConfig(**SERVED), mode='eval')
    assert int(rt.bins.num_pairs) > 0
    assert int(rt.bins.tile_overflow) == int(rj.tile_overflow)
    assert int(rt.bins.pair_overflow) == int(rj.pair_overflow) == 0
    np.testing.assert_allclose(rt.out.color.numpy(), rj.out.color, atol=1e-4)
    np.testing.assert_allclose(rt.out.alpha.numpy(), rj.out.alpha, atol=1e-4)
    np.testing.assert_allclose(rt.out.depth.numpy(), rj.out.depth,
                               rtol=1e-3, atol=1e-6)


# ---------------- depth colorization and metrics ----------------

def test_colorize_and_metrics_match_jax():
    rng = np.random.default_rng(3)
    depth = rng.uniform(0.5, 4.0, (24, 20)).astype(np.float32)
    depth[3:5, 2:6] = -99.0
    for kw in ({}, {'vmin': 1.0, 'vmax': 3.0}):
        np.testing.assert_array_equal(depthviz.colorize(depth, **kw),
                                      jax_depthviz.colorize(depth, **kw))
    ims = [rng.uniform(0, 1, (24, 20, 3)).astype(np.float32)
           for _ in range(3)]
    assert metrics.proxy_iqa(ims) == jax_metrics.proxy_iqa(ims)
    assert metrics.psnr(ims[0], ims[1]) == jax_metrics.psnr(ims[0], ims[1])


def test_colorize_gray_without_matplotlib(monkeypatch):
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    depth = np.linspace(0, 1, 12, dtype=np.float32).reshape(3, 4)
    img = depthviz.colorize(depth, vmin=0.0, vmax=1.0)
    assert img.dtype == np.uint8 and img.shape == (3, 4, 4)
    np.testing.assert_array_equal(img[..., 0], img[..., 1])
    np.testing.assert_array_equal(img[..., 0], (depth * 255).astype(np.uint8))


def test_run_logger_spans_and_trace(tmp_path):
    from bloomscene_tpu_torch.utils import logging, profiling
    log = logging.RunLogger(str(tmp_path / 'logs'))
    log.log({'loss': 0.5}, step=3)
    log.log({'loss': 0.25})
    log.close()
    with open(tmp_path / 'logs' / 'events.jsonl') as f:
        lines = [json.loads(ln) for ln in f]
    assert [r['loss'] for r in lines] == [0.5, 0.25]
    assert lines[0]['step'] == 3 and 'step' not in lines[1]
    assert log.history == lines

    spans = profiling.Spans()
    x = torch.ones(4)
    for _ in range(2):
        with spans.span('add', sync=x):
            x = x + 1
    summary = spans.summary()
    assert summary['add']['count'] == 2 and summary['add']['total_s'] > 0
    with profiling.trace(str(tmp_path / 'trace')) as prof:
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    assert any('mm' in e.key for e in prof.key_averages())
    with open(tmp_path / 'trace' / 'trace.json') as f:
        assert 'traceEvents' in json.load(f)
