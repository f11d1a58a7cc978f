"""Port parity: the densification surgery (``adjust_anchor`` with the Adam
moment surgery) against the JAX package, bitwise.

Both packages run the same numpy arithmetic on the host (the candidate
positions, the voxel dedup, the feature max, the stat bookkeeping) from
the same ``numpy.random.Generator`` seed, and write the same rows on the
device, so every result is compared for equality: the info counts, the
alive mask, every anchor-state leaf, the four statistics, and the first
and second Adam moments and count of every trained leaf. The statistics
and moments are fabricated from a seed, in the pattern of
tests/test_training.py::test_adjust_anchor_grow_and_prune.

Cases: grow and prune with free slots; growth past the capacity (the
state, statistics and per-anchor moments zero-padded to the next
capacity bucket); no candidate over the gradient threshold (prune only);
candidates at non-finite or huge positions, which are dropped.

The statistics' compacted accumulation (``accumulate_stats`` with
``anchor_idx``: the visible rows, then the padding C) against JAX's
``.at[].add`` bitwise too, on the tiny scene's capacity, inputs from a
seed, two views in a row.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bloomscene_tpu.config import GSConfig as JaxConfig
from bloomscene_tpu.models import densify as jax_densify
from bloomscene_tpu.models.anchors import init_from_points
from bloomscene_tpu.models.model import init_model as jax_init_model
from bloomscene_tpu.train.optim import make_optimizer
from bloomscene_tpu_torch.config import GSConfig
from bloomscene_tpu_torch.convert import (adam_moments, load_adam_moments,
                                          model_from_jax_params,
                                          model_to_numpy, optax_moments)
from bloomscene_tpu_torch.models import densify
from bloomscene_tpu_torch.train.optim import Adam, make_trainable

torch.set_num_threads(2)
CFG = dict(feat_dim=16, n_offsets=4, resolutions_3d=(18,),
           log2_hashmap_size_3d=8, resolutions_2d=(34,),
           log2_hashmap_size_2d=8, voxel_size=0.08, update_interval=20)
CASES = ('grow_and_prune', 'capacity_growth', 'no_candidates',
         'non_finite_candidates')


def points():
    pts = np.random.default_rng(4).uniform(-1, 1, (300, 3)).astype(
        np.float32)
    pts[:, 2] += 2.5
    return pts


def fabricate(case, m, cfg, rng):
    """(model, stats): hot children on the first 50 alive anchors (mean
    gradient 0.02 over 21 visits) with offsets spread so grown voxels are
    new, and zero opacity on the last 50 (prune candidates), per case."""
    C, K = m.state.capacity, cfg.n_offsets
    alive_idx = np.where(np.asarray(m.state.alive))[0]
    hot, cold = alive_idx[:50], alive_idx[-50:]
    ga = np.zeros((C, K), np.float32)
    gd = np.zeros((C, K), np.float32)
    if case != 'no_candidates':
        ga[hot] = 0.02 * 21
        gd[hot] = 21
    else:
        ga[hot] = 1e-5 * 21
        gd[hot] = 21
    oa = np.zeros(C, np.float32)
    ad = np.zeros(C, np.float32)
    oa[alive_idx] = 10.0
    if case != 'capacity_growth':
        oa[cold] = 0.0
    ad[alive_idx] = 40.0
    stats = jax_densify.DensifyStats(*map(jnp.asarray, (
        oa, ad, ga.reshape(-1), gd.reshape(-1))))
    off = np.array(m.state.offset)
    off[hot] = rng.uniform(-40, 40, (50, K, 3))
    if case == 'non_finite_candidates':
        off[hot[:10], :, 0] = np.inf
        off[hot[10:20], :, 1] = np.nan
        off[hot[20:30]] = 1e30
    st = m.state._replace(
        offset=jnp.asarray(off),
        feat=jnp.asarray(rng.normal(0, 1, (C, cfg.feat_dim)).astype(
            np.float32)),
        scaling_log=jnp.asarray(rng.normal(-3, 1, (C, 6)).astype(
            np.float32)))
    return m._replace(state=st), stats


def random_moments(opt_state, rng):
    """optax's state with every moment leaf drawn from a seed and the
    counts at 7."""
    def draw(x):
        if x.ndim == 0:
            return jnp.asarray(7, x.dtype)
        return jnp.asarray(rng.normal(size=x.shape).astype(x.dtype))
    return jax.tree.map(draw, opt_state)


def run_surgery(case):
    """The JAX and the port ``adjust_anchor`` on the same fabricated model,
    statistics and moments -> (JAX model, stats, optax state, info; the
    port's model, stats, info, Adam; the port's trained leaves before)."""
    rng = np.random.default_rng(CASES.index(case))
    jcfg, tcfg = JaxConfig(**CFG), GSConfig(**CFG)
    pts = points()
    capacity = 1024
    if case == 'capacity_growth':
        # no free slot: every grown anchor needs the next bucket
        capacity = init_from_points(
            pts, n_offsets=jcfg.n_offsets, feat_dim=jcfg.feat_dim,
            voxel_size=jcfg.voxel_size)[0].num_alive()
    m, vs = jax_init_model(jax.random.PRNGKey(0), pts, jcfg,
                           capacity=int(capacity))
    m, stats = fabricate(case, m, jcfg, rng)
    opt = make_optimizer(jcfg, 1.0, m)
    opt_state = random_moments(opt.init(m), rng)

    tm = make_trainable(model_from_jax_params(jax.tree.map(np.asarray, m),
                                              tcfg, device='cpu'))
    topt = Adam(tcfg, 1.0, tm)
    load_adam_moments(topt, optax_moments(jax.tree.map(np.asarray,
                                                       opt_state), topt))
    tstats = densify.DensifyStats(*(torch.from_numpy(np.array(x))
                                    for x in stats))
    leaves_before = [p for _, _, p in topt.params]

    jm, jstats, jopt, jinfo = jax_densify.adjust_anchor(
        m, stats, opt_state, jcfg, vs, np.random.default_rng(11))
    tm, tstats, tinfo = densify.adjust_anchor(
        tm, tstats, topt, tcfg, vs, np.random.default_rng(11))
    return (m, jm, jstats, jopt, jinfo), (tm, tstats, tinfo, topt,
                                          leaves_before)


@pytest.mark.parametrize('case', CASES)
def test_adjust_anchor_matches_jax(case):
    tcfg = GSConfig(**CFG)
    (m, jm, jstats, jopt, jinfo), (tm, tstats, tinfo, topt,
                                   leaves_before) = run_surgery(case)
    for k in ('n_new', 'n_pruned', 'n_alive', 'capacity', 'capacity_grown'):
        assert tinfo[k] == jinfo[k], (k, tinfo, jinfo)
    grown = case == 'capacity_growth'
    assert jinfo['capacity_grown'] == grown
    assert (jinfo['n_new'] > 0) == (case != 'no_candidates')
    assert (jinfo['n_pruned'] > 0) == (case != 'capacity_growth')
    assert tinfo['n_alive'] == (int(np.asarray(m.state.alive).sum())
                                + tinfo['n_new'] - tinfo['n_pruned'])

    got = model_to_numpy(tm)['state']
    for f in jm.state._fields:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(
            jm.state, '_' + f)), err_msg=f)
    for f, a, b in zip(jstats._fields, tstats, jstats):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)

    want = optax_moments(jax.tree.map(np.asarray, jopt), topt)
    have = adam_moments(topt)
    assert have['count'] == want['count'] == 7
    for tree in ('mu', 'nu'):
        assert set(have[tree]) == set(want[tree])
        for k in want[tree]:
            np.testing.assert_array_equal(have[tree][k], want[tree][k],
                                          err_msg=f"{tree} {k}")
    # without growth the trained leaves are the same tensors, written in
    # place; with it they are new leaves that require grad
    for (name, _, p), q in zip(topt.params, leaves_before):
        if name.startswith('state.'):
            assert (p is q) == (not grown), name
            assert p.requires_grad


def test_training_step_after_capacity_growth():
    """After the surgery grew the capacity, the trainer's step runs on the
    new leaves: the loss reaches them (grown rows included), Adam's moments
    match their shapes, and the step updates them in place."""
    from bloomscene_tpu_torch.examples.fit_single_view import build_scene
    from bloomscene_tpu_torch.models.anchors import update_anchor_bounds
    from bloomscene_tpu_torch.train.loop import make_train_step
    _, (tm, stats, info, opt, _) = run_surgery('capacity_growth')
    assert info['capacity_grown']
    cfg = GSConfig(**CFG, max_splats_per_tile=256)
    tm = tm._replace(bounds=update_anchor_bounds(tm.state))
    _, cam, img, depth = build_scene(res=32)
    step = make_train_step(cfg, cam.intrinsics, opt, torch.zeros(3))
    before = {n: p.detach().clone() for n, _, p in opt.params}
    tm, stats, met = step(tm, stats, cam.device_arrays('cpu'),
                          torch.from_numpy(img), torch.from_numpy(depth),
                          phase=0, track_stats=True)
    assert np.isfinite(float(met.loss)) and int(met.skipped) == 0
    assert stats.opacity_accum.shape[0] == info['capacity']
    for (name, _, p), m, v in zip(opt.params, opt.m, opt.v):
        assert m.shape == v.shape == p.shape, name
    leaves = tm.state.flat_leaves()
    for (name, _, p) in opt.params:
        if name.startswith('state.'):
            assert p is leaves[name[len('state.'):]], name
            assert p.shape[0] % info['capacity'] == 0
            assert not torch.equal(p.detach(), before[name]), name


# (visible anchors, padding entries, whether row C - 1 is visible)
STATS_CASES = {'padded': (40, 24, False), 'last_row_visible': (40, 24, True),
               'no_padding': (64, 0, False)}


@pytest.mark.parametrize('case', list(STATS_CASES))
def test_accumulate_stats_compacted_bitwise_jax(case):
    """The port's compacted ``accumulate_stats`` (on the CPU the plain
    version of the one-launch scatter: ``index_add`` over the index's rows)
    bitwise JAX's ``accumulate_stats`` (``.at[safe]`` and ``.at[flat_idx]``
    adds), two views accumulated in a row from seeded nonzero bases."""
    n_vis, n_pad, last = STATS_CASES[case]
    cfg = JaxConfig(**CFG)
    K = cfg.n_offsets
    st, _ = init_from_points(points(), n_offsets=K, feat_dim=cfg.feat_dim,
                             voxel_size=cfg.voxel_size)
    C = st.capacity
    rng = np.random.default_rng(list(STATS_CASES).index(case) + 20)
    base = (rng.uniform(0, 5, C), rng.uniform(0, 9, C),
            rng.uniform(0, 1, C * K), rng.uniform(0, 9, C * K))
    jstats = jax_densify.DensifyStats(*(jnp.asarray(b, jnp.float32)
                                        for b in base))
    tstats = densify.DensifyStats(*(torch.from_numpy(b.astype(np.float32))
                                    for b in base))
    for view in range(2):
        vis = np.sort(rng.choice(C - 1, n_vis - last, replace=False))
        if last:
            vis = np.append(vis, C - 1)
        idx = np.concatenate([vis, np.full(n_pad, C)]).astype(np.int32)
        V = idx.size
        nop = rng.normal(size=V * K).astype(np.float32)
        cv = rng.uniform(size=V * K) < 0.7
        sv = rng.uniform(size=V * K) < 0.8
        av = rng.uniform(size=C) < 0.6
        g = rng.normal(0, 1e-3, 2 * V * K).astype(np.float32)
        jstats = jax_densify.accumulate_stats(
            jstats, jnp.asarray(nop), jnp.asarray(cv), jnp.asarray(sv),
            jnp.asarray(av), jnp.asarray(g), 64, 48,
            anchor_idx=jnp.asarray(idx))
        tstats = densify.accumulate_stats(
            tstats, torch.from_numpy(nop), torch.from_numpy(cv),
            torch.from_numpy(sv), torch.from_numpy(av), torch.from_numpy(g),
            64, 48, anchor_idx=torch.from_numpy(idx))
        for f, a, b in zip(jstats._fields, tstats, jstats):
            assert a.shape == b.shape, f
            np.testing.assert_array_equal(
                a.numpy().view(np.int32), np.asarray(b).view(np.int32),
                err_msg=f"{f}, view {view}")
