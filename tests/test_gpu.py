"""Compiled-kernel checks that need an NVIDIA GPU (marker ``gpu``; they
skip elsewhere). chip_smoke.py's render phase runs the same comparisons at
the full ABC fixture size."""

import pytest

import chip_smoke as cs

pytestmark = pytest.mark.gpu


def test_compiled_seg_matches_oracle(gpu):
    scene, w, h = cs.load_fixture(scale=0.5, views=2)
    res = cs.compare_to_oracle(
        scene, w, h,
        dict(cs.ABC_GEOMETRY, pair_budget=cs.PAIR_BUDGET, pair_kernel="seg",
             backend="gpu"),
        dict(cs.ABC_GEOMETRY, backend="jax"))
    cs.check_agreement(res, "compiled seg vs oracle")


def test_compiled_seg_matches_per_pixel_reference(gpu):
    scene, _, _ = cs.load_fixture(views=1)
    res = cs.reference_check(
        scene, 0, 336, 336, 128,
        dict(cs.ABC_GEOMETRY, pair_budget=cs.PAIR_BUDGET, pair_kernel="seg",
             backend="gpu"))
    cs.check_reference(res, cs.ABC_GEOMETRY["capacity"])
