"""Port parity for the training step against the JAX package.

- The straight-through rules of ``ops/quantization.py`` against
  ``jax.vjp``: bitwise (elementwise masks and copies).
- ``expon_lr`` against the JAX schedule within 2e-7 relative, and two
  Adam updates per group against optax within 1e-6 relative and 1e-8
  absolute (about ten ulps of a 0.01-sized update): float32 exp/log/pow
  may differ in the last bit between torch and XLA, and XLA may fuse the
  update's multiply-adds; the rest is the same elementwise float32
  arithmetic.
- Each loss's value and gradient against ``jax.grad`` run op by op: value
  1e-6 relative, gradient 1e-6 absolute + 1e-4 relative (the SSIM
  convolution and the reductions sum in another order).
- ``accumulate_stats``, dense and compacted: 1e-6 relative (the norm).
- One ``_step_core`` on a tiny ``build_scene`` (64 px, 300 points, depth
  losses on) against the jitted JAX ``make_train_step`` after
  ``convert.model_from_jax_params``: the loss within 1e-5 relative, and
  every leaf's gradient (read from Adam's first moment, 0.1 g after one
  step in both) within ``NOISE_FLOOR`` = 1e-4 of the leaf's largest
  gradient. That floor is measured: the JAX package's own two blends
  ('pallas' in interpret mode and 'xla') give step gradients that differ
  by up to 3.4e-5 of the leaf's largest on this scene, dense and
  compacted (the port's differ from 'xla' by up to 4.5e-5: the blend
  backward's suffix form, the per-Gaussian sums' order, XLA's fused
  multiply-adds); ``test_jax_backends_agree_within_noise_floor`` holds
  the JAX gap below it. At least 75% of each leaf's nonzero gradient
  entries lie above the floor (83% at the least on this scene). Every
  parameter after the step matches within rtol 5e-3, atol 1e-4, the
  tolerance of tests/test_training.py:195, where the gradient lies above
  the floor; below it the gradient's sign is rounding noise, and Adam's
  eps 1e-15 turns it into a step of the learning rate's size either way
  (``assert_params_match``).
- One phase-2 step (dense; the hash-grid context, the adaptive noise from
  JAX's draws for the step's key, the rate) against the jitted JAX step:
  the loss within 1e-5 and the rate within 1e-4 relative; the leaves off
  the context path at ``NOISE_FLOOR`` as above; the leaves whose gradient
  runs through the context (the grid head, the hash tables, the anchors
  through the hash positions and the offsets through the adaptive noise)
  within ``CONTEXT_FLOOR`` = 2e-2 of the leaf's largest gradient. Under
  ``jax.jit`` XLA contracts multiply-adds in the hash grid and the
  entropy, and those gradients move by ~1e-2 of their largest on this
  scene (1.3% at most measured); tests/test_torch_decode_phases.py holds
  the same leaves within 1e-4 against JAX run op by op.
- Remat and no remat give the same phase-2 gradients, bitwise: the noise
  is drawn before the checkpoint.
- A 3-step run (the port's ``Trainer``) within that same tolerance, and
  ``Trainer.run`` through all three phases and two densification steps
  at 32 px, with the ``densify_*`` records.
- The torch ``fit_single_view`` at 64 px (250 points, 20 steps: the plain
  blend walks each tile's slots in Python) lowers the eval render's L1
  error.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bloomscene_tpu.config import GSConfig as JaxConfig
from bloomscene_tpu.models import anchors as jax_anchors
from bloomscene_tpu.models import densify as jax_densify
from bloomscene_tpu.models.model import init_model as jax_init_model
from bloomscene_tpu.ops import quantization as jq
from bloomscene_tpu.ops import tile_rasterizer as jax_tile_rasterizer
from bloomscene_tpu.ops.pallas import blend as pallas_blend
from bloomscene_tpu.scene.cameras import camera_from_rt as jax_camera
from bloomscene_tpu.train import losses as jl
from bloomscene_tpu.train.loop import make_train_step as jax_train_step
from bloomscene_tpu.train.optim import make_optimizer as jax_optimizer
from bloomscene_tpu.train.schedules import expon_lr as jax_expon_lr
from bloomscene_tpu_torch.config import GSConfig
from bloomscene_tpu_torch.convert import (adam_moments, leaf_key,
                                          model_from_jax_params,
                                          model_to_numpy)
from bloomscene_tpu_torch.examples import fit_single_view
from bloomscene_tpu_torch.models import densify
from bloomscene_tpu_torch.models.decode import DecodeNoise, draw_noise
from bloomscene_tpu_torch.ops import quantization as tq
from bloomscene_tpu_torch.scene.cameras import camera_from_rt
from bloomscene_tpu_torch.train import losses as tl
from bloomscene_tpu_torch.train.loop import (Trainer, make_train_step,
                                             step_gradients)
from bloomscene_tpu_torch.train.optim import (Adam, make_trainable,
                                              param_groups)
from bloomscene_tpu_torch.train.schedules import expon_lr

torch.set_num_threads(2)
STEP_CFG = dict(voxel_size=0.08, max_splats_per_tile=1024, use_dpr=True,
                start_stat=0, update_from=10 ** 9, iterations=3,
                noise_from_step=10 ** 9, context_from_step=10 ** 9)
RES = 64
# gradient entries below this share of their leaf's largest are rounding
# noise (the module docstring says how it was measured)
NOISE_FLOOR = 1e-4
RESOLVED_SHARE = 0.75
# phase 2: leaves whose gradient takes the hash-grid context's path, and
# their floor against the jitted JAX step (the module docstring says why)
CONTEXT_PATH = {('heads', 'grid'), ('grid', 'xyz'), ('grid', 'xy'),
                ('grid', 'xz'), ('grid', 'yz'), ('state', 'anchor'),
                ('state', 'offset')}
CONTEXT_FLOOR = 2e-2


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


# --- straight-through rules ---------------------------------------------

def _vjps(jfn, tfn, x, g, *extra):
    out_j, vjp = jax.vjp(lambda v: jfn(jnp.asarray(v), *extra), x)
    (gj,) = vjp(jnp.asarray(g))
    xt = t(x).requires_grad_(True)
    out_t = tfn(xt, *(t(e) if isinstance(e, np.ndarray) else e
                      for e in extra))
    (gt,) = torch.autograd.grad(out_t, xt, t(g))
    return np.asarray(out_j), out_t.detach().numpy(), np.asarray(gj), \
        gt.numpy()


def test_straight_through_rules_match_jax(rng):
    x = rng.normal(0, 1.5, (64, 8)).astype(np.float32)
    x[0, :4] = [1.0, -1.0, 0.0, 1e-7]                # the mask boundaries
    g = rng.normal(size=x.shape).astype(np.float32)
    for name, jfn, tfn, extra in (
            ('ste_binary', jq.ste_binary, tq.ste_binary, ()),
            ('ste_multistep', jq.ste_multistep, tq.ste_multistep,
             (np.full((64, 1), 0.25, np.float32), np.float32(0.1))),
            ('low_bound', lambda v: jq.low_bound(v, 0.3),
             lambda v: tq.low_bound(v, 0.3), ())):
        oj, ot, gj, gt = _vjps(jfn, tfn, x, g, *extra)
        if name != 'ste_multistep':      # its tanh: tests/test_torch_decode
            np.testing.assert_array_equal(ot, oj, err_msg=name)
        np.testing.assert_array_equal(gt, gj, err_msg=name)
    lo, hi = np.float32([[-2, -2, -2]]), np.float32([[2, 2, 2]])
    x3 = rng.uniform(-2, 2, (50, 3)).astype(np.float32)
    g3 = rng.normal(size=x3.shape).astype(np.float32)
    (qj, _), vjp = jax.vjp(lambda v: jq.quantize_anchor(v, lo, hi), x3)
    (gj,) = vjp((jnp.asarray(g3), jnp.zeros_like(qj)))
    xt = t(x3).requires_grad_(True)
    qt, _ = tq.quantize_anchor(xt, t(lo), t(hi))
    (gt,) = torch.autograd.grad(qt, xt, t(g3))
    np.testing.assert_array_equal(qt.detach().numpy(), np.asarray(qj))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))


# --- schedule and optimizer ---------------------------------------------

def test_expon_lr_matches_jax():
    for kw in ({}, {'lr_delay_steps': 20, 'lr_delay_mult': 0.01}):
        fj = jax_expon_lr(1.6e-3, 1.6e-6, max_steps=2990, **kw)
        ft = expon_lr(1.6e-3, 1.6e-6, max_steps=2990, **kw)
        for step in (0, 1, 7, 100, 1500, 2989, 2990, 4000, -1):
            np.testing.assert_allclose(float(ft(step)), float(fj(step)),
                                       rtol=2e-7, err_msg=f"{kw} {step}")


def named_jax(m) -> dict:
    """Leaves of a JAX-``Model``-shaped tree by canonical name, skipping
    optax's masked leaves."""
    out = {('state', f): getattr(m.state, '_' + f)
           for f in m.state._fields}
    for name, layers in m.heads.items():
        for i, layer in enumerate(layers):
            out[('heads', name, i, 'w')] = layer['w']
            out[('heads', name, i, 'b')] = layer['b']
    out.update({('grid', k): v for k, v in m.grid.items()})
    out.update({('bounds', f): getattr(m.bounds, f)
                for f in m.bounds._fields})
    return {k: np.asarray(v) for k, v in out.items()
            if not isinstance(v, optax.MaskedNode)}


def named_port(tree: dict) -> dict:
    """``model_to_numpy``'s nested dict by the same canonical names."""
    out = {('state', f): v for f, v in tree['state'].items()}
    for name, layers in tree['heads'].items():
        for i, layer in enumerate(layers):
            out[('heads', name, i, 'w')] = layer['w']
            out[('heads', name, i, 'b')] = layer['b']
    out.update({('grid', k): v for k, v in tree['grid'].items()})
    out.update({('bounds', k): v for k, v in tree['bounds'].items()})
    return out


def jax_moments(opt_state) -> dict:
    """Adam's first moment of every trained leaf, by canonical name."""
    out = {}
    for label, st in opt_state.inner_states.items():
        if label != 'frozen':
            out.update(named_jax(st.inner_state[0].mu))
    return out


def resolved(moment: np.ndarray) -> np.ndarray:
    """Entries whose gradient lies above the leaf's noise floor."""
    m = np.abs(moment)
    return m > NOISE_FLOOR * m.max()


def assert_params_match(got: dict, want: dict, moments: dict, opt: Adam,
                        steps: int, phase: int = 0):
    """Parameters after ``steps`` updates within rtol 5e-3, atol 1e-4
    wherever JAX's first moment lies above the noise floor. Below it the
    gradient is rounding noise whose sign either side may take, and Adam's
    eps 1e-15 turns even a 1e-11 gradient into a step of the full learning
    rate; there the two may differ by at most two such steps per update."""
    lr0 = {leaf_key(name)[0]: float(opt.lr[group](0))
           for name, group, _ in opt.params}
    for k in want:
        if k not in moments:             # frozen leaves and the bounds
            np.testing.assert_allclose(got[k], want[k], rtol=5e-3, atol=1e-4,
                                       err_msg=f"parameter {k}")
            continue
        floor = (CONTEXT_FLOOR if phase == 2 and k[:2] in CONTEXT_PATH
                 else NOISE_FLOOR)
        m = np.abs(moments[k])
        ok = (m > floor * m.max()).reshape(want[k].shape)
        np.testing.assert_allclose(got[k][ok], want[k][ok],
                                   rtol=5e-3, atol=1e-4,
                                   err_msg=f"parameter {k}")
        assert np.all(np.abs(got[k] - want[k])[~ok]
                      <= 2 * steps * lr0[k] * (1 + 1e-6)), f"parameter {k}"


@pytest.fixture(scope='module')
def small_models():
    pts = np.random.default_rng(3).uniform(-1, 1, (300, 3)).astype(
        np.float32) * 0.7
    pts[:, 2] += 2.5
    jcfg = JaxConfig(**STEP_CFG)
    m, vs = jax_init_model(jax.random.PRNGKey(0), pts, jcfg, capacity=512)
    m = m._replace(bounds=jax_anchors.update_anchor_bounds(m.state))
    return m, vs


def test_adam_update_per_group_matches_optax(small_models, rng):
    """Two updates with random gradients on every leaf: optax's
    multi_transform and the port's Adam end on the same parameters (the
    frozen leaves unchanged)."""
    m, _ = small_models
    cfg, jcfg = GSConfig(**STEP_CFG), JaxConfig(**STEP_CFG)
    tm = make_trainable(model_from_jax_params(jax.tree.map(np.asarray, m),
                                              cfg, device='cpu'))
    opt = Adam(cfg, 1.0, tm)
    jopt = jax_optimizer(jcfg, 1.0, m)
    state = jopt.init(m)
    update = jax.jit(jopt.update)
    for _ in range(2):
        g = jax.tree.map(
            lambda p: (jnp.asarray(rng.normal(size=p.shape).astype(p.dtype))
                       if jnp.issubdtype(p.dtype, jnp.floating)
                       else jnp.zeros_like(p)), m)
        upd, state = update(g, state, m)
        m = jax.tree.map(lambda p, u: p + u if jnp.issubdtype(
            p.dtype, jnp.floating) else p, m, upd)
        gn = named_jax(g)
        grads = []
        for name, _, p in opt.params:
            key, transposed = leaf_key(name)
            a = gn[key].T if transposed else gn[key]
            grads.append(torch.from_numpy(np.array(a)).reshape(
                p.shape))
        opt.step(grads)
    want = named_jax(m)
    got = named_port(model_to_numpy(tm))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-8,
                                   err_msg=str(k))


# --- losses --------------------------------------------------------------

def test_losses_match_jax(rng):
    H = W = 24
    img = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    img[:6, :6] = 0.0                         # exact-zero variance windows
    gt_img = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    gt_img[:6, :6] = 0.0
    dep = rng.uniform(0.5, 4, (H, W)).astype(np.float32)
    gt_dep = np.where(rng.uniform(size=(H, W)) < 0.3, 0.0,
                      rng.uniform(1, 3, (H, W))).astype(np.float32)
    consts = {'img': gt_img, 'dep': gt_dep}
    cases = {
        'l1': (lambda x, lib, c: lib.l1_loss(x, c['img']), img),
        'ssim': (lambda x, lib, c: lib.ssim(x, c['img']), img),
        'cmd_raw': (lambda x, lib, c: lib.cmd(x[None],
                                              c['dep'][None, None]), dep),
        'cmd_normalized': (lambda x, lib, c: lib.cmd(
            x[None], c['dep'][None, None], normalized=True), dep),
        'bilateral': (lambda x, lib, c: lib.bilateral_smoothness(x), dep),
        'huber_edge': (lambda x, lib, c: lib.huber_l1_edge_aware(
            x, c['dep'], c['img']), dep),
        'minmax': (lambda x, lib, c: 0.01 * lib.minmax_normalize(x).sum()
                   + lib.minmax_normalize(x)[3, 5], dep),
    }
    cj = {k: jnp.asarray(v) for k, v in consts.items()}
    ct = {k: t(v) for k, v in consts.items()}
    for name, (fn, x) in cases.items():
        vj, gj = jax.value_and_grad(lambda v: fn(v, jl, cj))(jnp.asarray(x))
        xt = t(x).requires_grad_(True)
        vt = fn(xt, tl, ct)
        (gt,) = torch.autograd.grad(vt, xt)
        np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-6,
                                   rtol=1e-4, err_msg=name)


# --- densify statistics ----------------------------------------------------

@pytest.mark.parametrize('compacted', [False, True])
def test_accumulate_stats_matches_jax(rng, compacted):
    C, K, V = 40, 4, 24
    W, H = 64, 48
    n = (V if compacted else C) * K
    base = [rng.uniform(0, 5, C).astype(np.float32),
            rng.uniform(0, 9, C).astype(np.float32),
            rng.uniform(0, 1, C * K).astype(np.float32),
            rng.uniform(0, 9, C * K).astype(np.float32)]
    nop = rng.normal(size=n).astype(np.float32)
    cv = rng.uniform(size=n) < 0.7
    sv = rng.uniform(size=n) < 0.8
    av = rng.uniform(size=C) < 0.6
    g = rng.normal(0, 1e-3, 2 * n).astype(np.float32)
    idx = None
    if compacted:
        idx = np.concatenate([np.sort(rng.choice(C, V - 5, replace=False)),
                              np.full(5, C)]).astype(np.int32)
    want = jax_densify.accumulate_stats(
        jax_densify.DensifyStats(*map(jnp.asarray, base)), jnp.asarray(nop),
        jnp.asarray(cv), jnp.asarray(sv), jnp.asarray(av), jnp.asarray(g),
        W, H, anchor_idx=None if idx is None else jnp.asarray(idx))
    got = densify.accumulate_stats(
        densify.DensifyStats(*map(t, base)), t(nop), torch.from_numpy(cv),
        torch.from_numpy(sv), torch.from_numpy(av), t(g), W, H,
        anchor_idx=None if idx is None else torch.from_numpy(idx))
    for f, a, b in zip(want._fields, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-9, err_msg=f)


# --- the step ----------------------------------------------------------------

@pytest.fixture(scope='module')
def jax_run(small_models):
    """``run(visible_capacity, n, pallas=False)``: n steps of the jitted
    JAX step on one view from the small model, one (state, metrics) per
    step (memoized), and the view. ``pallas`` renders through the JAX
    package's Pallas blend in interpret mode instead of its XLA scan."""
    m, _ = small_models
    pts, cam, img, depth = fit_single_view.build_scene(res=RES)
    jcam = jax_camera(np.eye(3), np.zeros(3), 1.0, 1.0, RES, RES)
    memo = {}

    def run(vcap, n, pallas=False, phase=0):
        if (vcap, n, pallas, phase) in memo:
            return memo[vcap, n, pallas, phase]
        jcfg = JaxConfig(**STEP_CFG, visible_capacity=vcap)
        opt = jax_optimizer(jcfg, 1.0, m)
        on_tpu = jax_tile_rasterizer._on_tpu
        if pallas:
            # the backend is chosen when the step is traced
            jax_tile_rasterizer._on_tpu = lambda: True
            pallas_blend.INTERPRET = True
        try:
            step = jax_train_step(jcfg, jcam.intrinsics, opt, jnp.zeros(3))
            out = steps(step, jcfg, opt, n, phase)
        finally:
            jax_tile_rasterizer._on_tpu = on_tpu
            pallas_blend.INTERPRET = False
        memo[vcap, n, pallas, phase] = out
        return out

    def steps(step, jcfg, opt, n, phase):
        state = (m, opt.init(m), jax_densify.init_stats(m.state.capacity,
                                                        jcfg.n_offsets))
        out = []
        for it in range(1, n + 1):
            track = jcfg.start_stat < it < jcfg.update_until
            *state, metrics = step(*state, jcam.device_arrays(),
                                   jnp.asarray(img), jnp.asarray(depth),
                                   jax.random.PRNGKey(it), phase=phase,
                                   track_stats=track)
            out.append((state, metrics))
        return out

    return run, (cam, img, depth)


@pytest.mark.parametrize('vcap', [None, 256])
def test_step_matches_jax(small_models, jax_run, vcap):
    """Dense decode, and decode of the visible anchors compacted into 256
    rows (the gradient goes back through the row gather)."""
    run, _ = jax_run
    check_step(small_models, jax_run, run(vcap, 3 if vcap is None else 1)[0],
               vcap, phase=0)


def test_phase2_step_matches_jax(small_models, jax_run):
    """A phase-2 step, dense: the hash-grid context, the adaptive noise
    (JAX's draws from the step's key, carried across) and the rate, the
    JAX step on its XLA blend."""
    run, _ = jax_run
    check_step(small_models, jax_run, run(None, 1, phase=2)[0], None,
               phase=2)


def jax_step_noise(key, phase, rows, cfg):
    """The draws JAX's decode takes from a step's key (decode.py:101-117),
    as the port's ``DecodeNoise``."""
    keys = jax.random.split(key, 3 if phase == 1 else 4)
    shapes = ((rows, cfg.feat_dim), (rows, 6), (rows, cfg.n_offsets, 3))
    normals = [torch.from_numpy(np.array(jax.random.normal(k, sh)))
               for k, sh in zip(keys, shapes)]
    choose = (torch.from_numpy(np.array(jax.random.uniform(
        keys[3], (rows,)))) if phase == 2 else None)
    return DecodeNoise(*normals, choose=choose)


def check_step(small_models, jax_run, jax_step, vcap, phase):
    """One port step from the small model against the JAX step's result
    ``jax_step`` ((model, opt_state, stats), metrics) after one step."""
    m, _ = small_models
    cfg = GSConfig(**STEP_CFG, visible_capacity=vcap)
    _, (cam, img, depth) = jax_run
    ((jm, jopt_state, jstats), jmet) = jax_step
    tm = make_trainable(model_from_jax_params(jax.tree.map(np.asarray, m),
                                              cfg, device='cpu'))
    opt = Adam(cfg, 1.0, tm)
    step = make_train_step(cfg, cam.intrinsics, opt, torch.zeros(3))
    noise = (jax_step_noise(jax.random.PRNGKey(1), phase,
                            tm.state.capacity, cfg) if phase else None)
    tm, stats, met = step(tm, densify.init_stats(tm.state.capacity,
                                                 cfg.n_offsets, 'cpu'),
                          cam.device_arrays('cpu'), t(img), t(depth),
                          phase=phase, track_stats=True, noise=noise)
    assert int(met.skipped) == 0 and int(met.tile_overflow) == 0
    np.testing.assert_allclose(float(met.loss), float(jmet.loss), rtol=1e-5)
    np.testing.assert_allclose(float(met.bit_per_param),
                               float(jmet.bit_per_param), rtol=1e-4)
    assert (float(jmet.bit_per_param) > 0) == (phase == 2)
    np.testing.assert_allclose(float(met.psnr), float(jmet.psnr), rtol=1e-5)
    assert int(met.n_visible_anchors) == int(jmet.n_visible_anchors)

    want_m, got_m = jax_moments(jopt_state), adam_moments(opt)['mu']
    assert set(got_m) == set(want_m)
    for k in want_m:
        scale = float(np.abs(want_m[k]).max())
        if phase == 2 and k[:2] in CONTEXT_PATH:
            np.testing.assert_allclose(got_m[k], want_m[k], rtol=0,
                                       atol=CONTEXT_FLOOR * scale,
                                       err_msg=f"gradient {k}")
            continue
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=0,
                                   atol=NOISE_FLOOR * scale,
                                   err_msg=f"gradient {k}")
        if scale > 0:
            nonzero = np.abs(want_m[k]) > 0
            share = float(resolved(want_m[k])[nonzero].mean())
            assert share >= RESOLVED_SHARE, (k, share)
    assert any(np.abs(v).max() > 0 for v in got_m.values())

    assert_params_match(named_port(model_to_numpy(tm)), named_jax(jm), want_m,
                        opt, steps=1, phase=phase)
    for f, a, b in zip(jstats._fields, stats, jstats):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-3,
                                   atol=1e-4, err_msg=f)


def test_jax_backends_agree_within_noise_floor(jax_run):
    """The reading behind ``NOISE_FLOOR``: one JAX step with the blend in
    its Pallas kernels (interpret mode) and one with its XLA scan give
    every leaf's gradient within the floor of each other (3.4e-5 of the
    leaf's largest at most on this scene, dense and compacted)."""
    run, _ = jax_run
    xla = jax_moments(run(None, 3)[0][0][1])
    pallas = jax_moments(run(None, 1, pallas=True)[0][0][1])
    assert set(xla) == set(pallas)
    for k in xla:
        scale = float(np.abs(xla[k]).max())
        np.testing.assert_allclose(pallas[k], xla[k], rtol=0,
                                   atol=NOISE_FLOOR * scale,
                                   err_msg=f"gradient {k}")


def test_three_step_run_matches_jax(small_models, jax_run):
    m, vs = small_models
    cfg = GSConfig(**STEP_CFG)
    run, (cam, img, depth) = jax_run
    runs = run(None, 3)
    tm = model_from_jax_params(jax.tree.map(np.asarray, m), cfg,
                               device='cpu')
    tr = Trainer(tm, cfg, cam.intrinsics, vs, device='cpu')
    got_m = tr.run([(cam.device_arrays('cpu'), t(img), t(depth))],
                   log_every=1)
    assert [r['iteration'] for r in tr.history] == [1, 2, 3]
    for rec, (_, jmet) in zip(tr.history, runs):
        np.testing.assert_allclose(rec['loss'], float(jmet.loss), rtol=1e-4)
        assert rec['skipped'] == 0
    (jm, jopt_state, _), _ = runs[-1]
    assert_params_match(named_port(model_to_numpy(got_m)), named_jax(jm),
                        jax_moments(jopt_state), tr.optimizer, steps=3)


def test_remat_and_no_remat_phase2_gradients_agree(small_models):
    """Checkpointing recomputes the decode in the backward; the noise is
    drawn before it, so the phase-2 gradients of every leaf are the same
    with remat and without (bitwise on the CPU)."""
    m, _ = small_models
    _, cam, img, depth = fit_single_view.build_scene(res=32)
    grads = {}
    for remat in (True, False):
        cfg = GSConfig(**STEP_CFG, remat=remat)
        tm = make_trainable(model_from_jax_params(
            jax.tree.map(np.asarray, m), cfg, device='cpu'))
        params = [p for _, _, p in param_groups(tm)]
        noise = draw_noise(tm.state.capacity, cfg, 2,
                           torch.Generator().manual_seed(5), 'cpu')
        *_, g, g_m2d = step_gradients(cfg, cam.intrinsics, torch.zeros(3),
                                      tm, params, cam.device_arrays('cpu'),
                                      t(img), t(depth), phase=2, noise=noise)
        grads[remat] = g + [g_m2d]
    assert any(float(x.abs().max()) > 0 for x in grads[True])
    for a, b in zip(grads[True], grads[False]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_trainer_runs_the_whole_schedule(small_models):
    """Trainer.run through phases 0, 1 and 2, the bounds refresh at
    context_from_step and two densification steps (3 and 6), at 32 px:
    finite losses, a positive rate in phase 2, and the densify records."""
    m, vs = small_models
    cfg = GSConfig(**{**STEP_CFG, 'iterations': 8, 'noise_from_step': 2,
                      'context_from_step': 4, 'update_from': 2,
                      'update_interval': 3, 'update_until': 100})
    cam = camera_from_rt(np.eye(3), np.zeros(3), 1.0, 1.0, 32, 32)
    _, _, img, depth = fit_single_view.build_scene(res=32)
    view = [(cam.device_arrays('cpu'), t(img), t(depth))]
    tm = model_from_jax_params(jax.tree.map(np.asarray, m), cfg,
                               device='cpu')
    tr = Trainer(tm, cfg, cam.intrinsics, vs, device='cpu')
    n0 = tr.model.state.num_alive()
    tr.run(view, log_every=1)
    hist = tr.history
    assert [r['iteration'] for r in hist] == list(range(1, 9))
    assert all(np.isfinite(r['loss']) and r['skipped'] == 0 for r in hist)
    assert all((r['bit_per_param'] > 0) == (r['iteration'] > 4)
               for r in hist)
    dens = [r for r in hist if 'densify_n_alive' in r]
    assert [r['iteration'] for r in dens] == [3, 6]
    for r in dens:
        assert set(k for k in r if k.startswith('densify_')) == {
            'densify_n_new', 'densify_n_pruned', 'densify_n_alive',
            'densify_capacity', 'densify_time_s'}
        assert r['densify_n_alive'] == n0 + r['densify_n_new'] \
            - r['densify_n_pruned']
        n0 = r['densify_n_alive']
    assert tr.model.state.num_alive() == n0
    assert tr.model.state.capacity == dens[-1]['densify_capacity']


@pytest.mark.parametrize('seed', [0, 7])
def test_camera_stream_apart_from_surgery_stream(small_models, seed):
    """The Trainer's camera draws come from a stream spawned from the seed,
    apart from the surgery's: ``densify_rng`` stays bitwise the JAX
    trainer's ``np_rng`` (``default_rng(seed)``), and the camera stream
    is another sequence."""
    m, vs = small_models
    cfg = GSConfig(**STEP_CFG)
    cam = camera_from_rt(np.eye(3), np.zeros(3), 1.0, 1.0, 32, 32)
    tm = model_from_jax_params(jax.tree.map(np.asarray, m), cfg,
                               device='cpu')
    tr = Trainer(tm, cfg, cam.intrinsics, vs, seed=seed, device='cpu')
    jax_np_rng = np.random.default_rng(seed)
    np.testing.assert_array_equal(tr.densify_rng.random(64),
                                  jax_np_rng.random(64))
    cams = tr.rng.integers(8, size=256)
    same_seed = np.random.default_rng(seed).integers(8, size=256)
    assert not np.array_equal(cams, same_seed)
    assert tr.rng.bit_generator.state != tr.densify_rng.bit_generator.state
    np.testing.assert_array_equal(
        cams, np.random.default_rng(np.random.SeedSequence(seed).spawn(1)[0])
        .integers(8, size=256))


def test_fit_single_view_improves_the_render():
    r = fit_single_view.fit(steps=20, res=RES, n_points=250, device='cpu',
                            log_every=5)
    assert np.isfinite(r['loss_last']) and r['loss_last'] < r['loss_first']
    assert r['l1_after'] < r['l1_before'], r
