"""The port's codec against the JAX package's.

- rANS, bit for bit both ways: for the same integer symbols and float64
  parameters, the port's ``encode_with_cdf``, ``encode_binary`` and
  ``encode_gaussian`` write the JAX package's bytes, each package decodes
  the other's, and the port's native coder writes its Python coder's
  bytes.
- The scene codec on tests/test_codec.py's toy scene (300 points at
  ``voxel_size=0.1``, 297 coded anchors), the JAX model converted with
  ``model_from_jax_params``: ``estimate_final_bits`` field by field within
  1e-3 relative; ``anchor_codes.npy``, ``hash.b`` and ``masks.b`` (which
  the context MLP does not condition) byte-identical, and the same file
  set and meta.json keys; the port's round trip meets
  tests/test_codec.py:131-193's assertions, the bit-exact re-encode
  included.
- The context floats: the port's MLP sums its products in another order
  than XLA's, so the context differs in the last bits and a JAX-written
  directory decoded by the port fails loudly through the digest. With
  the other package's context injected (``monkeypatch`` of
  ``_context_params_np`` on both sides), a JAX bitstream decodes in the
  port to JAX's decoded state bit for bit, and the reverse holds too.
- ``mode='decoded'`` decode values against JAX's op by op within 1e-5.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bloomscene_tpu.codec import codec as jax_codec
from bloomscene_tpu.codec import rans as jax_rans
from bloomscene_tpu.config import GSConfig as JaxConfig
from bloomscene_tpu.models.anchors import update_anchor_bounds
from bloomscene_tpu.models.decode import \
    decode_neural_gaussians as jax_decode
from bloomscene_tpu.models.model import init_model
from bloomscene_tpu_torch.codec import codec, rans
from bloomscene_tpu_torch.config import GSConfig
from bloomscene_tpu_torch.convert import model_from_jax_params
from bloomscene_tpu_torch.models.anchors import (get_mask, get_mask_anchor,
                                                 get_scaling)
from bloomscene_tpu_torch.models.decode import decode_neural_gaussians
from bloomscene_tpu_torch.models.heads import mlp_param_bits
from bloomscene_tpu_torch.ops.hashgrid import all_grid_params_flat

torch.set_num_threads(2)


def cdf_rows(rng, n: int, k: int) -> np.ndarray:
    probs = rng.dirichlet(np.ones(k) * 0.5, size=n)
    return np.concatenate([np.zeros((n, 1)), np.cumsum(probs, 1)], 1)


def test_rans_with_cdf_crosses_packages(rng):
    n, k = 3000, 8
    cdf = cdf_rows(rng, n, k)
    syms = np.array([rng.choice(k, p=np.diff(cdf[i])) for i in range(n)],
                    np.int32)
    ours = rans.encode_with_cdf(syms, cdf)
    assert ours == jax_rans.encode_with_cdf(syms, cdf)
    assert ours == rans.encode_with_cdf(syms, cdf, native=False)
    np.testing.assert_array_equal(jax_rans.decode_with_cdf(ours, cdf), syms)
    np.testing.assert_array_equal(rans.decode_with_cdf(ours, cdf), syms)
    np.testing.assert_array_equal(
        rans.decode_with_cdf(ours, cdf, native=False), syms)


def test_rans_binary_crosses_packages(rng):
    x = (rng.random(20000) < 0.23).astype(np.float32) * 2 - 1
    p = float((x > 0).mean())
    ours = rans.encode_binary(x, p)
    assert ours == jax_rans.encode_binary(x, p)
    assert ours == rans.encode_binary(x, p, native=False)
    np.testing.assert_array_equal(jax_rans.decode_binary(ours, p, x.size), x)
    np.testing.assert_array_equal(rans.decode_binary(ours, p, x.size), x)
    np.testing.assert_array_equal(
        rans.decode_binary(ours, p, x.size, as_pm1=False, native=False),
        (x > 0).astype(np.float32))


@pytest.mark.parametrize('spread', ['narrow', 'wide'])
def test_rans_gaussian_crosses_packages(rng, spread):
    """The mean-centred, width-bucketed gaussian streams (the native coder
    computes CDF edges on the fly from the shared Phi table, the Python
    coder builds the rows): one set of bytes in all three coders."""
    n = 3000
    if spread == 'narrow':
        mean, scale, q = (rng.normal(0, 2.0, n), rng.uniform(0.01, 1.0, n),
                          np.full(n, 0.01))
    else:
        mean, scale, q = (rng.normal(0, 5.0, n), rng.uniform(0.01, 0.1, n),
                          rng.uniform(0.0005, 0.002, n))
        scale[7] = 30.0                      # one very wide row
    x = rng.normal(mean, scale)
    ours = rans.encode_gaussian(x, mean, scale, q)
    assert ours == jax_rans.encode_gaussian(x, mean, scale, q)
    assert ours == rans.encode_gaussian(x, mean, scale, q, native=False)
    want = np.round(x / q) * q
    np.testing.assert_array_equal(
        jax_rans.decode_gaussian(ours, mean, scale, q),
        rans.decode_gaussian(ours, mean, scale, q))
    np.testing.assert_allclose(rans.decode_gaussian(ours, mean, scale, q),
                               want, atol=1e-9)
    np.testing.assert_array_equal(
        rans.decode_gaussian(ours, mean, scale, q, native=False),
        rans.decode_gaussian(ours, mean, scale, q))


def test_rans_gaussian_stores_a_run_too_wide_to_code(rng):
    """A width bucket whose residuals span more symbols than the 16-bit
    probabilities have slots (rows far wider than their step, as a briefly
    trained context predicts) is stored raw and decodes exactly, in both
    coders; without those rows the bytes stay the JAX package's."""
    n = 2000
    mean, scale, q = (rng.normal(0, 2.0, n), rng.uniform(0.01, 1.0, n),
                      np.full(n, 0.01))
    scale[:40] = rng.uniform(1e3, 2e3, 40)        # scale / q above 4096
    x = rng.normal(mean, scale)
    wide = rans._bucket_ids(scale, q) == len(rans._BUCKET_EDGES)
    span = np.round(x[wide] / q[wide]) - np.round(mean[wide] / q[wide])
    assert span.max() - span.min() + 1 >= 1 << 16
    ours = rans.encode_gaussian(x, mean, scale, q)
    assert ours == rans.encode_gaussian(x, mean, scale, q, native=False)
    want = np.round(x / q) * q
    for native in (True, False):
        np.testing.assert_allclose(
            rans.decode_gaussian(ours, mean, scale, q, native=native), want,
            atol=1e-9)
    narrow = ~wide
    assert rans.encode_gaussian(x[narrow], mean[narrow], scale[narrow],
                                q[narrow]) == jax_rans.encode_gaussian(
        x[narrow], mean[narrow], scale[narrow], q[narrow])


def test_phi_table_is_scipy_ndtr():
    """The Phi table of both coders: cephes' ndtr written in Python gives
    the bits of the scipy.special.ndtr that the JAX package's table
    takes."""
    np.testing.assert_array_equal(rans._phi_table(), jax_rans._phi_table())


@pytest.fixture(scope='module')
def scene():
    """tests/test_codec.py's toy scene in both packages."""
    rng = np.random.default_rng(0)
    jcfg, cfg = JaxConfig(voxel_size=0.1), GSConfig(voxel_size=0.1)
    pts = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    pts[:, 2] += 2.5
    jm, _ = init_model(jax.random.PRNGKey(0), pts, jcfg)
    st = jm.state
    C = st.capacity
    jm = jm._replace(state=st._replace(
        feat=jnp.asarray(rng.normal(0, 1, (C, jcfg.feat_dim)), jnp.float32),
        offset=jnp.asarray(rng.normal(0, 0.3, (C, jcfg.n_offsets, 3)),
                           jnp.float32),
        mask_logit=jnp.asarray(rng.normal(2, 3, (C, jcfg.n_offsets, 1)),
                               jnp.float32)))
    jm = jm._replace(bounds=update_anchor_bounds(jm.state))
    pm = model_from_jax_params(jax.tree.map(np.asarray, jm), cfg,
                               device='cpu')
    return jm, jcfg, pm, cfg


@pytest.fixture(scope='module')
def encoded(scene, tmp_path_factory):
    """Each package's bitstream directory of the scene."""
    jm, jcfg, pm, cfg = scene
    root = tmp_path_factory.mktemp('codec')
    jdir, pdir = str(root / 'jax'), str(root / 'port')
    jax_sizes = jax_codec.encode_scene(jm, jcfg, jdir)
    sizes = codec.encode_scene(pm, cfg, pdir)
    return jdir, jax_sizes, pdir, sizes


def read(path: str, name: str) -> bytes:
    with open(os.path.join(path, name), 'rb') as f:
        return f.read()


def test_estimate_matches_jax(scene):
    jm, jcfg, pm, cfg = scene
    want = jax_codec.estimate_final_bits(jm, jcfg)
    got = codec.estimate_final_bits(pm, cfg)
    assert set(got) == set(want)
    assert got['n_anchors'] == want['n_anchors'] == 297
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-3, err_msg=k)
    # the helpers the estimate uses, exactly
    assert mlp_param_bits(pm.heads) == \
        jax_codec.heads_lib.mlp_param_bits(jm.heads)
    np.testing.assert_array_equal(
        all_grid_params_flat(pm.grid).numpy(),
        np.asarray(jax_codec.all_grid_params_flat(jm.grid)))


def test_files_match_jax(encoded):
    """The streams the context does not condition are JAX's bytes; the
    file set and meta.json's keys are JAX's."""
    jdir, jax_sizes, pdir, sizes = encoded
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))
    for name in ('anchor_codes.npy', 'hash.b', 'masks.b'):
        assert read(pdir, name) == read(jdir, name), name
    with open(os.path.join(jdir, 'meta.json')) as f:
        jmeta = json.load(f)
    with open(os.path.join(pdir, 'meta.json')) as f:
        meta = json.load(f)
    assert sorted(meta) == sorted(jmeta)
    for k in ('n', 'chunk', 'backend', 'prob_hash', 'prob_masks',
              'bounds_min', 'bounds_max'):
        assert meta[k] == jmeta[k], k
    assert set(sizes) == set(jax_sizes)
    for k in ('anchor_MB', 'hash_MB', 'masks_MB', 'MLPs_MB', 'n_anchors'):
        assert sizes[k] == jax_sizes[k], k


def test_round_trip(scene, encoded, tmp_path):
    """tests/test_codec.py:131-193 on the port: the decoded scene's masks,
    features, scalings and hash tables, and a bit-exact re-encode."""
    jm, jcfg, pm, cfg = scene
    _, _, pdir, sizes = encoded
    timings = {}
    decoded = codec.decode_scene(pm, cfg, pdir, timings=timings,
                                 device='cpu')
    n = sizes['n_anchors']
    assert decoded.state.num_alive() == n
    assert set(timings) == {'hash_s', 'masks_s', 'context_s', 'rans_s',
                            'state_s'}
    st = pm.state
    alive = (st.alive & (get_mask_anchor(st) > 0)).numpy()
    np.testing.assert_array_equal(get_mask(decoded.state).numpy(),
                                  get_mask(st).numpy()[alive])
    assert np.abs(decoded.state.feat.numpy() - st.feat.numpy()[alive]).max() \
        < 2 * cfg.q_base_feat
    assert np.abs(get_scaling(decoded.state).numpy()
                  - get_scaling(st).numpy()[alive]).max() \
        < 2 * cfg.q_base_scaling + 1e-5
    ob = all_grid_params_flat(pm.grid).numpy()
    np.testing.assert_array_equal(np.where(ob >= 0, 1, -1),
                                  all_grid_params_flat(decoded.grid).numpy())
    path2 = str(tmp_path / 'again')
    codec.encode_scene(decoded, cfg, path2)
    streams = sorted(f for f in os.listdir(pdir) if f.endswith('.b'))
    assert len(streams) == 3 * 1 + 2
    for name in streams:
        assert read(pdir, name) == read(path2, name), name


def test_context_floats_differ_in_last_bits(scene):
    """Why a bitstream does not cross between the packages: on the same
    code-reconstructed anchors the two context MLPs agree to ~1e-6 but not
    bit for bit (they sum their matrix products in other orders; on this
    scene 12-14% of each entropy-parameter block's entries are equal)."""
    jm, jcfg, pm, cfg = scene
    _, arr = jax_codec._alive_arrays(jm, jcfg)
    want = jax_codec._context_params_np(jm, arr['anchor'], jcfg)
    got = codec._context_params_np(pm, arr['anchor'], cfg)
    shares = [float(np.mean(a == b)) for a, b in zip(got, want)]
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=1e-5)
    assert max(shares[:6]) < 0.9, shares


def test_jax_bitstream_fails_loudly_in_the_port(scene, encoded):
    """The context floats differ in the last bits between the packages,
    so the digest refuses JAX's directory in the port (and the port's in
    JAX) instead of decoding a garbled scene."""
    jm, jcfg, pm, cfg = scene
    jdir, _, pdir, _ = encoded
    with pytest.raises(RuntimeError, match='context-model mismatch'):
        codec.decode_scene(pm, cfg, jdir, device='cpu')
    with pytest.raises(RuntimeError, match='context-model mismatch'):
        jax_codec.decode_scene(jm, jcfg, pdir)


def test_perturbed_mlp_fails_loudly(scene, encoded):
    """As tests/test_codec.py::test_decode_detects_context_mismatch: a
    perturbed grid-MLP weight raises at decode; the pristine shell still
    decodes."""
    jm, jcfg, pm, cfg = scene
    _, _, pdir, sizes = encoded
    import copy
    bad_heads = copy.deepcopy(pm.heads)
    with torch.no_grad():
        bad_heads.grid[0].weight.view(-1)[3] += 0.25
    with pytest.raises(RuntimeError, match='context-model mismatch'):
        codec.decode_scene(pm._replace(heads=bad_heads), cfg, pdir,
                           device='cpu')
    assert codec.decode_scene(pm, cfg, pdir, device='cpu') \
        .state.num_alive() == sizes['n_anchors']


def decoded_state(model) -> dict:
    """A decoded model's leaves as numpy arrays, either package."""
    if isinstance(model.state, jax_codec.AnchorState):
        st = {k: np.asarray(v) for k, v in model.state._asdict().items()}
        grid = {k: np.asarray(v) for k, v in model.grid.items()}
        bounds = [np.asarray(b) for b in model.bounds]
    else:
        st = {k: v.numpy() for k, v in model.state.flat_leaves().items()}
        grid = {k: v.numpy() for k, v in model.grid.items()}
        bounds = [b.numpy() for b in model.bounds]
    flat = {f'state.{k}': v.reshape(-1) for k, v in st.items()}
    flat.update({f'grid.{k}': v for k, v in grid.items()})
    flat.update({'x_min': bounds[0].reshape(-1),
                 'x_max': bounds[1].reshape(-1)})
    return flat


@pytest.mark.parametrize('direction', ['jax_to_port', 'port_to_jax'])
def test_cross_decode_with_injected_context(scene, encoded, monkeypatch,
                                            direction):
    """With the encoding package's context parameters injected into the
    decoding package, a bitstream decodes to the encoding package's own
    decoded state, bit for bit."""
    jm, jcfg, pm, cfg = scene
    jdir, _, pdir, _ = encoded
    jax_ctx, port_ctx = (jax_codec._context_params_np,
                         codec._context_params_np)
    if direction == 'jax_to_port':
        want = jax_codec.decode_scene(jm, jcfg, jdir)
        monkeypatch.setattr(codec, '_context_params_np',
                            lambda m, a, c: jax_ctx(jm, a, jcfg))
        got = codec.decode_scene(pm, cfg, jdir, device='cpu')
    else:
        want = codec.decode_scene(pm, cfg, pdir, device='cpu')
        monkeypatch.setattr(jax_codec, '_context_params_np',
                            lambda m, a, c: port_ctx(pm, a, cfg))
        got = jax_codec.decode_scene(jm, jcfg, pdir)
    got, want = decoded_state(got), decoded_state(want)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_decoded_mode_matches_jax(scene):
    """mode='decoded' takes the attributes as they are (no context, no
    quantization): the port's decode against JAX's op by op."""
    jm, jcfg, pm, cfg = scene
    cam = np.array([0.1, -0.2, 0.3], np.float32)
    want, _ = jax_decode(jm, jnp.asarray(cam), jcfg, phase=0,
                         mode='decoded')
    got, rate = decode_neural_gaussians(pm, torch.from_numpy(cam), cfg,
                                        mode='decoded')
    assert rate is None
    for name in got._fields:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5,
                                       err_msg=name)
    assert got.valid.any()
