"""The port's ring render (``parallel/ring.py``) and the (2, 2) mesh on
gloo ranks over a ``file://`` store, spawned by ``parallel.launch.spawn``
and joined under a deadline.

- ``ring_render`` on rings of 2 and 4 ranks, tests/test_ring.py's scenes
  (n = 64 and 128 at 32x32): values against JAX's ``rasterize_reference``
  (color atol/rtol 1e-5, depth 1e-4) and the gradients of test_ring.py's
  loss for mean2d, conic, colors and opacities against ``jax.grad`` of the
  same loss through ``rasterize_reference`` (atol 3e-5 of the largest,
  rtol 2e-4), with the scene's minimum final T above 2e-4 as the
  precondition there; every rank holds the same image and gradients.
  H or n not divisible by the ring's size is refused.
- A 4-rank (2, 2) mesh: its shape, each rank's index along each axis, the
  ranks of each axis' group, and the sums, gathers and shifts along them.
"""
import os
import threading

import numpy as np
import pytest
import torch

from bloomscene_tpu_torch.ops.projection import ProjectedSplats
from bloomscene_tpu_torch.parallel.launch import spawn
from bloomscene_tpu_torch.parallel.mesh import AxisGroup
from bloomscene_tpu_torch.parallel.ring import ring_render

torch.set_num_threads(2)
W = H = 32
SCENES = ((64, 0), (128, 3))     # (n, seed), test_ring.py's
BG = [0.1, 0.2, 0.3]
SPAWN_TIMEOUT = 120


def ring_results(out, group) -> dict:
    """For each scene: the ring's image and the gradients of the loss."""
    res = {}
    for n, seed in SCENES:
        with np.load(os.path.join(out, f'scene{n}.npz')) as f:
            arrs = {k: torch.from_numpy(f[k]) for k in f.files}
        leaves = {k: arrs[k].clone().requires_grad_(True)
                  for k in ('mean2d', 'conic', 'colors', 'opac')}
        proj = ProjectedSplats(*(leaves.get(k, arrs[k])
                                 for k in ProjectedSplats._fields))
        color, depth = ring_render(proj, leaves['colors'], leaves['opac'],
                                   torch.tensor(BG), W, H, group)
        loss = (torch.mean((color - arrs['tgt_c']) ** 2)
                + 0.3 * torch.mean((depth - arrs['tgt_d']) ** 2))
        grads = torch.autograd.grad(loss, list(leaves.values()))
        res[n] = dict(color=color.detach(), depth=depth.detach(),
                      loss=loss.detach(),
                      grads=dict(zip(leaves, (g.detach() for g in grads))))
    return res


def mesh_results(mesh) -> dict:
    import torch.distributed as dist
    data, tile = mesh.axis('data'), mesh.axis('tile')
    me = torch.tensor([float(mesh.rank)])
    return dict(
        shape=mesh.shape, rank=mesh.rank, index=(data.index, tile.index),
        groups=(dist.get_process_group_ranks(data.group),
                dist.get_process_group_ranks(tile.group)),
        sums=(float(data.all_reduce(me.clone())),
              float(tile.all_reduce(me.clone()))),
        gathered=[float(x) for x in tile.all_gather(me)],
        shifted=(float(data.shift(me)), float(tile.shift(me, -1))))


def ring_worker(rank, world, store, out):
    torch.set_num_threads(1)
    from bloomscene_tpu_torch.parallel.mesh import init_distributed, make_mesh
    init_distributed('gloo', f'file://{store}', world, rank, device='cpu')
    res = {'ring': ring_results(out, make_mesh(1, world).axis('tile'))}
    if world == 4:
        res['mesh'] = mesh_results(make_mesh(2, 2))
    torch.save(res, os.path.join(out, f'rank{rank}.pt'))


@pytest.fixture(scope='module')
def reference(tmp_path_factory):
    """The scenes projected by JAX (saved for the ranks), and
    ``rasterize_reference``'s image and gradients of each."""
    import jax
    import jax.numpy as jnp
    from bloomscene_tpu.ops.reference_rasterizer import rasterize_reference
    from test_ring import _project, _scene
    out = str(tmp_path_factory.mktemp('ring'))
    bg = jnp.asarray(BG, jnp.float32)
    ref = {}
    for n, seed in SCENES:
        means, scales, quats, colors, opac = _scene(n, seed)
        proj = _project(means, scales, quats, W, H)
        rng = np.random.default_rng(seed + 100)
        tgt_c = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
        tgt_d = rng.uniform(0, 5, (H, W)).astype(np.float32)
        np.savez(os.path.join(out, f'scene{n}.npz'), colors=colors,
                 opac=opac, tgt_c=tgt_c, tgt_d=tgt_d,
                 **{k: np.asarray(v) for k, v in proj._asdict().items()})

        def loss_ref(mean2d, conic, col, op, proj=proj, tgt_c=tgt_c,
                     tgt_d=tgt_d):
            o = rasterize_reference(proj._replace(mean2d=mean2d, conic=conic),
                                    col, op, bg, W, H, tile=None)
            return (jnp.mean((o.color - tgt_c) ** 2)
                    + 0.3 * jnp.mean((o.depth - tgt_d) ** 2)), o
        (val, o), g = jax.jit(jax.value_and_grad(
            loss_ref, argnums=(0, 1, 2, 3), has_aux=True))(
                proj.mean2d, proj.conic, jnp.asarray(colors),
                jnp.asarray(opac))
        # exactness precondition: no pixel reaches the reference's early
        # stop (ring.py's docstring)
        assert float(jnp.min(o.final_T)) > 2e-4
        ref[n] = dict(color=np.asarray(o.color), depth=np.asarray(o.depth),
                      loss=float(val), grads=dict(zip(
                          ('mean2d', 'conic', 'colors', 'opac'),
                          (np.asarray(x) for x in g))))
    return out, ref


@pytest.fixture(scope='module')
def rings(reference):
    """Each ring size's ranks' results (both rings run at once)."""
    out, _ = reference
    failed = []

    def run(world):
        d = os.path.join(out, f'world{world}')
        os.makedirs(d)
        for n, _ in SCENES:
            os.link(os.path.join(out, f'scene{n}.npz'),
                    os.path.join(d, f'scene{n}.npz'))
        try:
            spawn(ring_worker, world, (os.path.join(d, 'store'), d),
                  timeout=SPAWN_TIMEOUT)
        except RuntimeError as e:
            failed.append(e)
    threads = [threading.Thread(target=run, args=(w,)) for w in (2, 4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if failed:
        raise failed[0]
    return {world: [torch.load(os.path.join(out, f'world{world}',
                                            f'rank{r}.pt'),
                               weights_only=False) for r in range(world)]
            for world in (2, 4)}


@pytest.mark.parametrize('world', [2, 4])
@pytest.mark.parametrize('n', [n for n, _ in SCENES])
def test_ring_render_matches_reference(reference, rings, world, n):
    _, ref = reference
    want = ref[n]
    first = rings[world][0]['ring'][n]
    np.testing.assert_allclose(first['color'].numpy(), want['color'],
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(first['depth'].numpy(), want['depth'],
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(first['loss']), want['loss'], rtol=1e-5,
                               atol=1e-7)
    for nm, b in want['grads'].items():
        a = first['grads'][nm].numpy()
        assert np.isfinite(a).all(), nm
        scale = max(float(np.abs(b).max()), 1e-8)
        np.testing.assert_allclose(a, b, atol=3e-5 * scale, rtol=2e-4,
                                   err_msg=f"grad mismatch: {nm}")
    # every rank holds the same image and the whole gradient
    for other in rings[world][1:]:
        o = other['ring'][n]
        assert torch.equal(o['color'], first['color'])
        assert torch.equal(o['depth'], first['depth'])
        for nm in want['grads']:
            assert torch.equal(o['grads'][nm], first['grads'][nm]), nm


def test_ring_render_rejects_indivisible():
    """H = 30 or n = 63 on a ring of 4: refused before any exchange (the
    group stands for one rank of four and holds no process group)."""
    from test_ring import _project, _scene
    group = AxisGroup('ring', 4, 0, None)
    for n, size in ((64, 30), (63, 32)):
        means, scales, quats, colors, opac = _scene(n)
        proj = ProjectedSplats(*(torch.from_numpy(np.array(a)) for a in
                                 _project(means, scales, quats, size, size)))
        with pytest.raises(ValueError):
            ring_render(proj, torch.from_numpy(colors),
                        torch.from_numpy(opac), torch.zeros(3), size, size,
                        group)


def test_four_rank_mesh_axes(rings):
    """Ranks data-major on the (2, 2) mesh: rank = 2 d + t."""
    for r, res in enumerate(rings[4]):
        m = res['mesh']
        d, t = divmod(r, 2)
        assert m['shape'] == {'data': 2, 'tile': 2} and m['rank'] == r
        assert m['index'] == (d, t)
        assert m['groups'] == ([t, 2 + t], [2 * d, 2 * d + 1])
        assert m['sums'] == (float(t + 2 + t), float(4 * d + 1))
        assert m['gathered'] == [float(2 * d), float(2 * d + 1)]
        # from the previous data rank, and from the next tile rank
        assert m['shifted'] == (float(2 * ((d - 1) % 2) + t),
                                float(2 * d + (t + 1) % 2))
