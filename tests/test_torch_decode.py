"""Port parity: hash grid, quantizers, anchor init and the neural decode
against the JAX package, with the JAX parameters carried across by
``model_from_jax_params``.

The JAX functions run op by op (not under ``jax.jit``, where XLA may
contract a multiply and an add into one fused multiply-add), which is the
arithmetic the port reproduces. Elementwise float32 code (hash grid, sign,
anchor quantization) is asserted bitwise; STE_multistep's tanh term within 1e-6 relative (torch's tanh and
XLA's differ in the last bit). Decode outputs go through the MLP heads, whose matrix
products sum in another order in torch than in XLA: 1e-5 absolute and
relative (float32 rounding of ~50-term dot products). In eval mode a
one-ulp difference in the quantization step can move ``round(x / q)`` to
the neighbouring integer; such flips are counted, must stay rare (below
0.1% of the quantized values), and every other value holds the tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bloomscene_tpu.config import GSConfig as JaxConfig
from bloomscene_tpu.models import anchors as jax_anchors
from bloomscene_tpu.models.decode import decode_neural_gaussians as jax_decode
from bloomscene_tpu.ops import hashgrid as jh
from bloomscene_tpu.ops import quantization as jq
from bloomscene_tpu.ops.knn import _knn_exact as jax_knn_exact
from bloomscene_tpu.ops.knn import knn_mean_sq_dist as jax_knn
from bloomscene_tpu_torch.config import GSConfig
from bloomscene_tpu_torch.convert import model_from_jax_params
from bloomscene_tpu_torch.models import anchors as tanchors
from bloomscene_tpu_torch.models.decode import decode_neural_gaussians
from bloomscene_tpu_torch.ops import hashgrid as th
from bloomscene_tpu_torch.ops import quantization as tq
from bloomscene_tpu_torch.ops.knn import knn_mean_sq_dist

torch.set_num_threads(2)
NARROW = dict(feat_dim=16, n_offsets=4, resolutions_3d=(18, 24, 33),
              log2_hashmap_size_3d=10, resolutions_2d=(130,),
              log2_hashmap_size_2d=10, voxel_size=0.08,
              max_splats_per_tile=256)


def jax_model(pts, rng, cfg):
    """A JAX-package ``Model`` whose parameters are drawn with numpy:
    anchors from the JAX package's init_from_points, features and offsets
    at a trained scale (both are zero at init), heads with torch's default
    Linear bounds, hash tables uniform in +-1e-4."""
    from bloomscene_tpu.models.model import Model, mix_spec
    state, _ = jax_anchors.init_from_points(
        pts, n_offsets=cfg.n_offsets, feat_dim=cfg.feat_dim,
        voxel_size=cfg.voxel_size)
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
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (1500, 3)).astype(np.float32)
    pts[:, 2] += 2.5
    jcfg, tcfg = JaxConfig(**NARROW), GSConfig(**NARROW)
    m = jax_model(pts, rng, jcfg)
    tm = model_from_jax_params(jax.tree.map(np.asarray, m), tcfg,
                               device='cpu')
    return m, tm, jcfg, tcfg, pts


@pytest.mark.parametrize('num_dim,res,log2', [(3, (18, 514), 10),
                                              (2, (130, 1026), 9)])
def test_grid_encode_bitwise(rng, num_dim, res, log2):
    """Dense and hashed levels (uint32 hash emulated in int64), boundary
    ring exclusion, out-of-range inputs."""
    js = jh.GridSpec(num_dim, 4, res, log2)
    ts = th.GridSpec(num_dim, 4, res, log2)
    params = rng.uniform(-1e-4, 1e-4, js.n_params * 4).astype(np.float32)
    x = rng.uniform(-0.05, 1.05, (500, num_dim)).astype(np.float32)
    want = np.asarray(jh.grid_encode(jnp.asarray(params), jnp.asarray(x),
                                     js))
    got = th.grid_encode(torch.from_numpy(params), torch.from_numpy(x), ts)
    np.testing.assert_array_equal(got.numpy(), want)


def test_quantizers_match_jax(rng):
    x = rng.normal(0, 2, (400, 6)).astype(np.float32)
    q = rng.uniform(0.01, 0.5, (400, 1)).astype(np.float32)
    # half-way points exercise round-half-to-even
    x[:8, 0] = (np.arange(8) + 0.5) * q[:8, 0]
    mean = np.float32(0.1)
    want = jq.ste_multistep(jnp.asarray(x), jnp.asarray(q), mean)
    got = tq.ste_multistep(torch.from_numpy(x), torch.from_numpy(q),
                           torch.tensor(mean))
    # the rounding is exact; torch's tanh and XLA's differ in the last bit
    np.testing.assert_array_equal(
        np.round(got.numpy() / q), np.round(np.asarray(want) / q))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(
        tq.ste_binary(torch.from_numpy(x)).numpy(),
        np.asarray(jq.ste_binary(jnp.asarray(x))))
    lo, hi = x.min(0, keepdims=True), x.max(0, keepdims=True)
    for a, b in zip(tq.quantize_anchor(torch.from_numpy(x),
                                       torch.from_numpy(lo),
                                       torch.from_numpy(hi)),
                    jq.quantize_anchor(jnp.asarray(x), jnp.asarray(lo),
                                       jnp.asarray(hi))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_init_from_points_and_knn(models):
    m, _, _, tcfg, pts = models
    st, vs = tanchors.init_from_points(pts, n_offsets=tcfg.n_offsets,
                                       feat_dim=tcfg.feat_dim,
                                       device=torch.device('cpu'),
                                       voxel_size=tcfg.voxel_size)
    j_alive = np.asarray(m.state.alive)
    assert vs == tcfg.voxel_size and st.capacity == m.state.capacity
    np.testing.assert_array_equal(st.alive.numpy(), j_alive)
    np.testing.assert_array_equal(st.anchor.numpy(),
                                  np.asarray(m.state.anchor))
    # 3-NN mean of three float32 squared distances, summed in either order
    np.testing.assert_allclose(st.scaling_log.numpy()[j_alive],
                               np.asarray(m.state.scaling_log)[j_alive],
                               rtol=1e-6, atol=1e-6)
    p = pts[:300]
    np.testing.assert_allclose(knn_mean_sq_dist(torch.from_numpy(p)).numpy(),
                               np.asarray(jax_knn_exact(jnp.asarray(p))),
                               rtol=1e-6)


@pytest.mark.parametrize('n', [300, 1500, 5000, 20000])
def test_knn_bitwise_jax(n):
    """Up to 2048 points the exact path, above it the Morton search: the
    mean of the 3 squared distances is XLA's sum times float32(1/3), bit
    for bit."""
    p = np.random.default_rng(n).uniform(-1, 1, (n, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        knn_mean_sq_dist(torch.from_numpy(p)).numpy(),
        np.asarray(jax_knn(jnp.asarray(p))))


# seeded clouds on which a divide by 3 gave another median 3-NN distance,
# so other anchors, than JAX's
@pytest.mark.parametrize('seed', [102, 105, 108])
def test_init_adaptive_voxel_bitwise_jax(seed):
    """``voxel_size=0``: the median 3-NN distance as the voxel size, then
    the anchors, bitwise JAX's; the offset scales within 1e-6."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (int(rng.integers(300, 3000)), 3)).astype(
        np.float32)
    st, vs = tanchors.init_from_points(pts, n_offsets=4, feat_dim=8,
                                       device=torch.device('cpu'),
                                       voxel_size=0.0)
    jst, jvs = jax_anchors.init_from_points(pts, n_offsets=4, feat_dim=8,
                                            voxel_size=0.0)
    assert vs == jvs and st.capacity == jst.capacity
    np.testing.assert_array_equal(st.alive.numpy(), np.asarray(jst.alive))
    np.testing.assert_array_equal(st.anchor.numpy(), np.asarray(jst.anchor))
    np.testing.assert_allclose(st.scaling_log.numpy(),
                               np.asarray(jst.scaling_log),
                               rtol=1e-6, atol=1e-6)


def test_knn_morton_path_near_exact(rng):
    """Above 2048 points: the rotated multi-pass Morton search, mostly
    exact (the bound tests/test_model_decode.py puts on the JAX one)."""
    p = torch.from_numpy(rng.uniform(0, 1, (3000, 3)).astype(np.float32))
    approx = knn_mean_sq_dist(p).numpy()
    from bloomscene_tpu_torch.ops.knn import _knn_exact
    exact = _knn_exact(p).numpy()
    rel = np.abs(approx - exact) / exact
    assert np.quantile(rel, 0.9) < 1e-6 and np.quantile(rel, 0.99) < 0.5


def _rounding_indices(get_anchor, interp, grid_head, scaling, st, bounds,
                      cfg, F, K):
    """(hash-grid context, round(x / q) of the three eval-quantized
    attributes) per anchor."""
    ctx = interp(get_anchor(st, bounds))
    out = np.asarray(grid_head(ctx))
    adj = out[:, 2 * F + 12 + 6 * K:]
    q = [base * (1 + np.tanh(adj[:, i:i + 1])) for i, base in enumerate(
        (cfg.q_base_feat, cfg.q_base_scaling, cfg.q_base_offsets))]
    feat = np.asarray(st.feat).reshape(-1, F)
    off = np.asarray(st.offset).reshape(-1, K * 3)
    return np.asarray(ctx), np.concatenate(
        [np.round(feat / q[0]), np.round(np.asarray(scaling(st)) / q[1]),
         np.round(off / q[2])], 1)


@pytest.mark.parametrize('mode', ['train', 'eval'])
def test_decode_matches_jax(models, mode):
    from bloomscene_tpu.models import heads as jax_heads
    from bloomscene_tpu.models.model import calc_interp_feat as jax_interp
    from bloomscene_tpu_torch.models import heads as theads
    from bloomscene_tpu_torch.models.model import calc_interp_feat
    m, tm, jcfg, tcfg, _ = models
    F, K = tcfg.feat_dim, tcfg.n_offsets
    cam = np.array([0.1, -0.2, 0.3], np.float32)
    dj, _ = jax_decode(m, jnp.asarray(cam), jcfg, phase=0, mode=mode)
    dt, _ = decode_neural_gaussians(tm, torch.from_numpy(cam), tcfg,
                                    phase=0, mode=mode)
    alive = np.asarray(m.state.alive)
    flipped = np.zeros(alive.shape, bool)
    if mode == 'eval':
        # anchors whose quantization index differs between the packages
        ctx_want, want = _rounding_indices(
            jax_anchors.get_anchor_quantized,
            lambda a: jax_interp(m, a, jcfg),
            lambda c: jax_heads.apply_grid(m.heads, c),
            jax_anchors.get_scaling, m.state, m.bounds, jcfg, F, K)
        with torch.no_grad():
            ctx_got, got = _rounding_indices(
                tanchors.get_anchor_quantized,
                lambda a: calc_interp_feat(tm, a, tcfg),
                lambda c: theads.apply_grid(tm.heads, c),
                tanchors.get_scaling, tm.state, tm.bounds, tcfg, F, K)
        # the hash-grid context (mix_encode over the model's tables) is
        # elementwise float32 and matches bitwise
        np.testing.assert_array_equal(ctx_got, ctx_want)
        flipped = (got != want).any(1) & alive
        assert flipped.sum() <= 1e-3 * alive.sum(), \
            f"{flipped.sum()} of {alive.sum()} anchors round differently"
    keep = np.repeat(alive & ~flipped, K)
    np.testing.assert_array_equal(dt.valid.numpy()[keep],
                                  np.asarray(dj.valid)[keep])
    for f in dt._fields:
        if f == 'valid':
            continue
        np.testing.assert_allclose(getattr(dt, f).numpy()[keep],
                                   np.asarray(getattr(dj, f))[keep],
                                   atol=1e-5, rtol=1e-5, err_msg=f)
