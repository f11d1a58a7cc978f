"""The card-vs-CPU gradient gate of ``chip_smoke.py`` (phases 9 and 17) on
synthetic tensors.

Every leaf is held to P2_GRAD_TOL (1e-3) of its largest CPU gradient. A
leaf past it may pass only through rows shown to sit at a forward
decision boundary (at most MAX_BOUNDARY_ROWS), and only if the same step
with those rows dead passes on every leaf:

- a planted fault on a row away from any boundary fails, with or without
  a boundary flip elsewhere;
- an opacity-mask flip within a few ulps of 0, with the pair it drops,
  passes with its row reported, and is left out of the rerun;
- a flip far from its threshold, more boundary rows than allowed, or a
  rerun that still fails, fails.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

C, K = 16, 2
NAMES = ['state.feat', 'state.anchor', 'heads.opacity.0.weight']
FAULT_ROW, FLIP_ROW = 5, 9


def gradients(seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((C, 8), generator=g), torch.randn((C, 3), generator=g),
            torch.randn((6, 4), generator=g)]


def near(grads, seed=1):
    """The CPU's gradients as a card would give them: 1e-6 apart."""
    g = torch.Generator().manual_seed(seed)
    return [x + 1e-6 * torch.randn(x.shape, generator=g) for x in grads]


def decisions():
    """Every anchor visible, every child valid with opacity 0.5, each
    child's one pair kept at tile 0 (a 32x32 view of 16-pixel tiles)."""
    M = C * K
    return {'visible': torch.ones(C, dtype=torch.bool),
            'anchor_depth': torch.full((C,), 2.0), 'near': 0.2,
            'opacity': torch.full((M,), 0.5),
            'opacity_scale': torch.ones(M),
            'dec_valid': torch.ones(M, dtype=torch.bool),
            'child_valid': torch.ones(M, dtype=torch.bool),
            'mean2d': torch.full((M, 2), 8.0),
            'conic': torch.tensor([[0.5, 0.0, 0.5]]).repeat(M, 1),
            'opac_eff': torch.full((M,), 0.5),
            'pairs': torch.stack([torch.arange(M),
                                  torch.zeros(M, dtype=torch.long)], 1),
            'width': 32, 'tile': 16}


def flip_opacity(card, cpu, row, card_x=3e-8, cpu_x=-2e-8):
    """Child 0 of ``row`` valid on the card, masked on the CPU, with its
    pair kept on the card only."""
    c = row * K
    card['opacity'][c], cpu['opacity'][c] = card_x, cpu_x
    cpu['dec_valid'][c] = cpu['child_valid'][c] = False
    cpu['opac_eff'][c] = 0.0
    cpu['pairs'] = cpu['pairs'][cpu['pairs'][:, 0] != c]


def with_excess(grads, row):
    """The gradients with the row's feature gradient and the head moved
    past the tolerance."""
    out = [x.clone() for x in grads]
    out[0][row] += 0.05 * float(grads[0].abs().max())
    out[2][0, 0] += 0.05 * float(grads[2].abs().max())
    return out


class Rerun:
    """``grad_gate``'s rerun: the gradients with the given rows dead."""

    def __init__(self, card, cpu):
        self.card, self.cpu, self.rows = card, cpu, None

    def __call__(self, rows):
        self.rows = rows
        return self.card, self.cpu


def gate(card_g, cpu_g, card_d, cpu_d, rerun=None):
    rerun = rerun or Rerun(near(cpu_g), cpu_g)
    return chip_smoke.grad_gate(NAMES, card_g, cpu_g, card_d, cpu_d, rerun)


def test_gradients_within_tolerance_pass():
    cpu = gradients()
    report, ok = gate(near(cpu), cpu, decisions(), decisions())
    assert ok and report['excused_rows'] == []


@pytest.mark.parametrize('flip_elsewhere', [False, True])
def test_planted_fault_away_from_a_boundary_fails(flip_elsewhere):
    cpu = gradients()
    card_d, cpu_d = decisions(), decisions()
    if flip_elsewhere:
        flip_opacity(card_d, cpu_d, FLIP_ROW)
    report, ok = gate(with_excess(near(cpu), FAULT_ROW), cpu, card_d, cpu_d)
    assert not ok and report['excused_rows'] == []
    assert report['excess_rows'] == [FAULT_ROW]
    assert report['boundary_rows'] == ([FLIP_ROW] if flip_elsewhere else [])


def test_boundary_flip_passes_with_its_row_reported():
    cpu = gradients()
    card_d, cpu_d = decisions(), decisions()
    flip_opacity(card_d, cpu_d, FLIP_ROW)
    rerun = Rerun(near(cpu), cpu)
    report, ok = gate(with_excess(near(cpu), FLIP_ROW), cpu, card_d, cpu_d,
                      rerun)
    assert ok and rerun.rows == [FLIP_ROW]
    (row,) = report['excused_rows']
    assert row['row'] == FLIP_ROW
    assert row['margin_ulps'] <= chip_smoke.BOUNDARY_ULPS
    kinds = [d['decision'] for d in row['decisions']]
    assert kinds == ['opacity_mask']       # its pair goes with its validity
    # the tolerance is the same after the rows are left out
    assert all(v['err_over_max'] <= chip_smoke.P2_GRAD_TOL
               for v in report['leaves_without_excused_rows'].values())
    assert chip_smoke.P2_GRAD_TOL == 1e-3


def test_flip_far_from_its_threshold_fails():
    cpu = gradients()
    card_d, cpu_d = decisions(), decisions()
    flip_opacity(card_d, cpu_d, FLIP_ROW, card_x=0.01, cpu_x=-0.01)
    report, ok = gate(with_excess(near(cpu), FLIP_ROW), cpu, card_d, cpu_d)
    assert not ok and report['boundary_rows'] == []
    assert report['flipped_rows'][str(FLIP_ROW)]['margin_ulps'] > 1e4


def test_more_boundary_rows_than_allowed_fail():
    cpu = gradients()
    card_d, cpu_d = decisions(), decisions()
    rows = [3, 7, FLIP_ROW][:chip_smoke.MAX_BOUNDARY_ROWS + 1]
    for r in rows:
        flip_opacity(card_d, cpu_d, r)
    report, ok = gate(with_excess(near(cpu), FLIP_ROW), cpu, card_d, cpu_d)
    assert not ok and report['boundary_rows'] == rows


def test_rerun_that_still_fails_fails():
    cpu = gradients()
    card_d, cpu_d = decisions(), decisions()
    flip_opacity(card_d, cpu_d, FLIP_ROW)
    still = Rerun(with_excess(near(cpu), FAULT_ROW), cpu)
    report, ok = gate(with_excess(near(cpu), FLIP_ROW), cpu, card_d, cpu_d,
                      still)
    assert not ok and still.rows == [FLIP_ROW]


def test_pair_cull_flip_at_its_threshold():
    """A pair kept on one side only, its exponent at the cull threshold:
    the splat's centre 3 px past the tile's edge, the opacity chosen so
    that log(255 * opacity) + 1e-3 equals the exponent there."""
    card_d, cpu_d = decisions(), decisions()
    c = FLIP_ROW * K
    qmin = np.float32(0.5 * 0.5 * 3.0 ** 2)
    op = float(np.exp(np.float64(qmin) - 1e-3) / 255.0)
    for d in (card_d, cpu_d):
        d['mean2d'][c] = torch.tensor([13.0, 8.0])     # tile 1 starts at 16
        d['opac_eff'][c] = op
    card_d['pairs'] = torch.cat([card_d['pairs'], torch.tensor([[c, 1]])])
    flips = chip_smoke.decision_flips(card_d, cpu_d)
    assert list(flips) == [FLIP_ROW]
    (d,) = flips[FLIP_ROW]['decisions']
    assert d['decision'] == 'pair_cull' and d['kept_on'] == 'card'
    assert flips[FLIP_ROW]['margin_ulps'] <= chip_smoke.BOUNDARY_ULPS
