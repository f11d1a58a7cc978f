"""The compacted decode's row gather (``models/anchors.py::SortedRowGather``,
its backward ``ops/cuda/gather_rows_bwd.py``) on the CPU.

- The Function's forward is ``x.reshape(C, -1)[idx]`` bit for bit; its
  backward (the plain ``index_add_``, sequential on the CPU) is ``jax.vjp``
  of the JAX package's ``AnchorState.gather_rows`` bit for bit (XLA's CPU
  scatter-add also adds a row's entries in entry order from 0), on
  tests/test_torch_kernels.py's cases: padding runs of 0, 1, 2, 1,000 and
  10,000 entries, row C - 1 live, runs across the kernel's chunks. It is
  torch's autograd of ``x[idx]`` bit for bit where a run holds at most
  one nonzero cotangent (the padding cases); where runs of up to 513
  entries are all nonzero, torch's CPU ``index_put_`` adds the wider
  leaves' runs in another order (measured: the 30- and 50-float leaves
  at 2 threads), so there the two lie within (longest run) x 2^-24 of
  each row's summed magnitudes, the bound on two float32 sums' rounding.
- ``compact_visible``'s index is nondecreasing (the Function's
  precondition) for random, all-visible, none-visible and over-capacity
  masks.
- In a compacted training step the padding entries' cotangents are exactly
  zero on every trained leaf in phases 0, 1 and 2, with row C - 1 dead and
  with it live, and the step's gradients (every parameter) are those of
  the plain indexing's backward bit for bit in phases 0 and 2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bloomscene_tpu.models import anchors as jax_anchors
from bloomscene_tpu_torch.config import GSConfig
from bloomscene_tpu_torch.convert import model_to
from bloomscene_tpu_torch.examples import fit_single_view
from bloomscene_tpu_torch.models import anchors
from bloomscene_tpu_torch.models.anchors import (AnchorState,
                                                 update_anchor_bounds)
from bloomscene_tpu_torch.models.decode import draw_noise
from bloomscene_tpu_torch.models.model import init_model
from bloomscene_tpu_torch.models.render import (compact_visible,
                                                prefilter_anchors)
from bloomscene_tpu_torch.train.loop import decoded_rows, step_gradients
from bloomscene_tpu_torch.train.optim import Adam, make_trainable
from test_torch_kernels import (GATHER_CASES, GATHER_WIDTHS, gather_case,
                                int_bits)

torch.set_num_threads(2)
TRAINED = ('anchor', 'offset', 'mask_logit', 'feat', 'scaling_log')
FROZEN_WIDTHS = {'rotation': 4, 'opacity_raw': 1}
# cases whose runs add several nonzero cotangents (the others hold one
# nonzero entry a run at most, as a training step's padding does)
SUMMED_RUNS = ('chunk_edges', 'aligned')
RES = 32
STEP_CFG = dict(voxel_size=0.08, max_splats_per_tile=256, use_dpr=True,
                start_stat=0, update_from=10 ** 9, iterations=3,
                noise_from_step=10 ** 9, context_from_step=10 ** 9)


def case_state(C: int, seed: int):
    """Random flat leaves of a C-row state: the trained ones at
    GATHER_WIDTHS, rotation, opacity and alive."""
    rng = np.random.default_rng(seed)
    leaves = {f: rng.normal(size=C * k).astype(np.float32)
              for f, k in zip(TRAINED, GATHER_WIDTHS)}
    leaves.update({f: rng.normal(size=C * k).astype(np.float32)
                   for f, k in FROZEN_WIDTHS.items()})
    leaves['alive'] = rng.uniform(size=C) < 0.9
    return leaves


@pytest.mark.parametrize('case', GATHER_CASES)
def test_gather_rows_matches_indexing_and_jax(case):
    grads, idx, C, _ = gather_case(case)
    leaves = case_state(C, 1)
    st = AnchorState(**{f: torch.from_numpy(v).requires_grad_(f in TRAINED)
                        for f, v in leaves.items()})
    alive = st.alive[idx]
    sub = st.gather_rows(idx, alive)
    for f, x in st.flat_leaves().items():
        if f != 'alive':
            want = x.detach().reshape(C, -1)[idx].reshape(-1)
            assert torch.equal(int_bits(sub.flat_leaves()[f].detach()),
                               int_bits(want)), f
    trained = [st.flat_leaves()[f] for f in TRAINED]
    outs = [sub.flat_leaves()[f] for f in TRAINED]
    got = torch.autograd.grad(outs, trained,
                              [g.reshape(-1) for g in grads])
    plain = [x.reshape(C, -1)[idx].reshape(-1) for x in trained]
    want = torch.autograd.grad(plain, trained,
                               [g.reshape(-1) for g in grads])
    longest = int(torch.unique(idx, return_counts=True)[1].max())
    for f, a, b, g in zip(TRAINED, got, want, grads):
        if case not in SUMMED_RUNS:
            assert torch.equal(int_bits(a), int_bits(b)), f
            continue
        # torch's CPU index_put_ adds a long run of wide rows in another
        # order than entry order: two float32 sums of n terms differ by at
        # most (n - 1) 2^-24 of the summed magnitudes
        mag = torch.zeros(C, g.shape[1]).index_add_(0, idx, g.abs())
        assert bool(((a - b).abs() <= longest * 2.0 ** -24
                     * mag.reshape(-1)).all()), f

    def jax_gather(*trained_leaves):
        js = jax_anchors.AnchorState(
            **dict(zip(TRAINED, trained_leaves)),
            **{f: jnp.asarray(leaves[f]) for f in FROZEN_WIDTHS},
            alive=jnp.asarray(leaves['alive']))
        out = js.gather_rows(jnp.asarray(idx.numpy()),
                             jnp.asarray(alive.numpy()))
        return tuple(getattr(out, '_' + f) for f in TRAINED)
    _, vjp = jax.vjp(jax_gather, *(jnp.asarray(leaves[f]) for f in TRAINED))
    jax_grads = vjp(tuple(jnp.asarray(g.numpy().reshape(-1))
                          for g in grads))
    for f, a, b in zip(TRAINED, got, jax_grads):
        assert np.array_equal(a.numpy().view(np.int32),
                              np.asarray(b).view(np.int32)), f


@pytest.mark.parametrize('share,bucket', [(0.3, 128), (1.0, 128),
                                          (0.0, 128), (1.0, 500),
                                          (0.5, 64)])
def test_compact_visible_index_is_nondecreasing(share, bucket):
    """Random visible masks over 512 rows with every row alive: all
    visible with the bucket under (over capacity) and above the count,
    none visible, and partial ones."""
    model, _ = init_model(0, fit_single_view.build_scene(300)[0],
                          GSConfig(**STEP_CFG), capacity=512, device='cpu')
    C = model.state.capacity
    model = model._replace(state=model.state._replace(
        alive=torch.ones(C, dtype=torch.bool)))
    for seed in range(4):
        visible = torch.from_numpy(
            np.random.default_rng(seed).uniform(size=C) < share)
        _, idx = compact_visible(model, visible, bucket)
        safe = torch.clamp(idx, max=C - 1)
        assert bool((safe[1:] >= safe[:-1]).all())
        assert bool(((safe >= 0) & (safe < C)).all())
        n = min(int(visible.sum()), bucket)
        assert bool((idx[n:] == C).all()) and bool((idx[:n] < C).all())


@pytest.fixture(scope='module')
def step_scene():
    """``(model, cam, img, depth)``: 300 shell points at RES px with
    bounds, and the same scene cut to its alive anchors with 30 of them
    dead, so that row C - 1 is alive and visible."""
    pts, cam, img, depth = fit_single_view.build_scene(n_points=300,
                                                       res=RES)
    model, _ = init_model(0, pts, GSConfig(**STEP_CFG), capacity=512,
                          device='cpu')
    model = model._replace(bounds=update_anchor_bounds(model.state))
    n = model.state.num_alive()
    keep = torch.arange(n)
    alive = torch.ones(n, dtype=torch.bool)
    alive[torch.from_numpy(np.random.default_rng(5).choice(
        n - 1, 30, replace=False))] = False
    cut = model._replace(state=model.state.gather_rows(keep, alive))
    return {'dead_last': model, 'live_last': cut}, cam, img, depth


def compacted_step(model, cam, img, depth, phase: int, plain: bool,
                   monkeypatch):
    """One compacted step's gradients (every parameter) and the cotangents
    the gather's backward took, with the bucket 16 rows above the visible
    count (so it is padded); ``plain`` gathers every leaf by indexing, the
    backward torch's."""
    arrs = cam.device_arrays('cpu')
    visible = prefilter_anchors(model, cam.intrinsics, arrs)
    n_vis = int(visible.sum())
    cfg = GSConfig(**STEP_CFG, visible_capacity=n_vis + 16)
    assert model.state.capacity > cfg.visible_capacity
    tm = make_trainable(model_to(model, 'cpu'))
    params = [p for _, _, p in Adam(cfg, 1.0, tm).params]
    noise = (draw_noise(decoded_rows(tm, cfg), cfg, phase,
                        torch.Generator().manual_seed(3), 'cpu')
             if phase else None)
    taken = []

    def record(grads, idx, n_rows):
        taken.append(([g.clone() for g in grads], idx.clone()))
        return original(grads, idx, n_rows)

    def plain_gather(self, idx, alive):
        C = self.capacity
        return AnchorState(alive=alive, **{
            f: x.reshape(C, -1)[idx]
            for f, x in self.flat_leaves().items() if f != 'alive'})

    original = anchors.gather_rows_bwd
    with monkeypatch.context() as m:
        m.setattr(anchors, 'gather_rows_bwd', record)
        if plain:
            m.setattr(AnchorState, 'gather_rows', plain_gather)
        *_, grads, _ = step_gradients(
            cfg, cam.intrinsics, torch.zeros(3), tm, params, arrs,
            torch.from_numpy(img), torch.from_numpy(depth), phase, noise)
    assert len(taken) == (0 if plain else 1)
    return grads, taken, n_vis


@pytest.mark.parametrize('which', ['dead_last', 'live_last'])
def test_compacted_step_padding_and_gradients(step_scene, which,
                                              monkeypatch):
    """The padding entries' cotangents are exactly zero on every trained
    leaf in phases 0-2, row C - 1's run holds them (with one live entry
    for ``live_last``), and in phases 0 and 2 every gradient of the step
    is the plain indexing's bit for bit."""
    models, cam, img, depth = step_scene
    model = models[which]
    C = model.state.capacity
    assert bool(model.state.alive[C - 1]) == (which == 'live_last')
    for phase in (0, 1, 2):
        grads, taken, n_vis = compacted_step(model, cam, img, depth, phase,
                                             False, monkeypatch)
        cot, idx = taken[0]
        assert [g.shape[1] for g in cot] == list(GATHER_WIDTHS)
        assert bool((idx[n_vis:] == C - 1).all())
        assert (int(idx[n_vis - 1]) == C - 1) == (which == 'live_last')
        for f, g in zip(TRAINED, cot):
            assert bool((g[n_vis:] == 0).all()), (phase, f)
            assert bool(torch.isfinite(g).all()), (phase, f)
        if phase == 1:
            continue
        want, _, _ = compacted_step(model, cam, img, depth, phase, True,
                                    monkeypatch)
        for i, (a, b) in enumerate(zip(grads, want)):
            assert torch.equal(int_bits(a), int_bits(b)), (phase, i)
