"""``chip_smoke.py``'s model-phase rule on the CPU: the kernels' logits
against the plain reference, where a top-1 flip passes only as a
near-tie under the fixed ``NEAR_TIE_LOGITS`` bound, with no allowance
on the number of flips and no bound that grows with the logits'
difference. The script itself needs a card; only its pure helper runs
here (loaded from its file, so nothing of it runs at import)."""

import importlib.util
from pathlib import Path

import pytest
import torch

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)

BOUND = chip_smoke.NEAR_TIE_LOGITS


def _logits(positions=8, vocab=16, seed=0):
    gen = torch.Generator().manual_seed(seed)
    # Top-1 at token 0 by a clear margin of 4 logits everywhere.
    ref = torch.rand((positions, vocab), generator=gen)
    ref[:, 0] = 5.0
    return ref


def test_equal_logits_pass_without_flips():
    ref = _logits()
    c = chip_smoke.compare_logits(ref.clone(), ref)
    assert c["ok"] and c["flips"] == 0 and c["diff"] == 0.0
    assert c["positions"] == 8 and c["margins"] == []


@pytest.mark.parametrize("margin,ok", [(BOUND / 2, True),
                                       (BOUND * 0.99, True),
                                       (BOUND, False), (BOUND * 2, False)])
def test_a_flip_passes_only_under_the_fixed_bound(margin, ok):
    ref = _logits()
    ref[3, 7] = 5.0 - margin  # the reference's runner-up at position 3
    got = ref.clone()
    got[3, 7] = 5.0 + 1e-3  # the kernels pick it
    c = chip_smoke.compare_logits(got, ref)
    assert c["flips"] == 1
    assert c["margins"] == pytest.approx([margin], abs=1e-6)
    assert c["ok"] is ok


def test_many_near_tie_flips_pass_with_no_count_allowance():
    """Every position flips on a near-tie: no share of positions is
    refused for being many."""
    ref = _logits()
    ref[:, 1] = 5.0 - BOUND / 4
    got = ref.clone()
    got[:, 1] = 5.0 + 1e-3
    c = chip_smoke.compare_logits(got, ref)
    assert c["ok"] and c["flips"] == 8


def test_a_larger_difference_does_not_excuse_a_larger_flip():
    """A flip past the bound fails even where the logits moved by more
    than the margin everywhere (the old rule allowed 2 * diff)."""
    ref = _logits() * 10  # top-1 at 50: 5% of it is 2.5 logits
    ref[2, 5] = 50.0 - 3 * BOUND
    got = ref + 4 * BOUND  # every logit moved by more than the margin
    got[2, 5] = got[2, 0] + 1e-3
    c = chip_smoke.compare_logits(got, ref)
    assert c["diff"] <= 0.05 * c["scale"]  # within the 5% rule
    assert c["diff"] > c["margins"][0] / 2  # the old rule let it pass
    assert not c["ok"]


def test_margin_is_measured_at_the_kernels_pick():
    """The margin is the reference's best minus its logit at the token
    the kernels picked, not at its own runner-up."""
    ref = _logits()
    ref[0, 2] = 5.0 - BOUND / 2  # the reference's runner-up, a near-tie
    ref[0, 9] = 5.0 - 2 * BOUND  # the kernels' pick is further down
    got = ref.clone()
    got[0, 9] = 6.0
    c = chip_smoke.compare_logits(got, ref)
    assert c["margins"] == pytest.approx([2 * BOUND], abs=1e-6)
    assert not c["ok"]


@pytest.mark.parametrize("bad", ["nan", "far"])
def test_non_finite_or_distant_logits_fail(bad):
    ref = _logits()
    got = ref.clone()
    if bad == "nan":
        got[1, 1] = float("nan")
    else:
        got[1, 1] += 0.06 * ref.abs().max()
    assert not chip_smoke.compare_logits(got, ref)["ok"]
