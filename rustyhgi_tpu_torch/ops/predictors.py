"""Interpolation predictors.

Counterpart of ``rustyhgi_tpu/ops/predictors.py`` (reference:
src/interpolator.rs):

* ``crossed`` — the production predictor (interpolator.rs:57-91): the
  exact integer rounding tree over the four enclosing-cell corners
  (interpolator.rs:41-55), out-of-bounds corners reading 0;
* ``left_top`` — the nearest-anchor predictor (interpolator.rs:15-28):
  the cell-origin value.

Both read only the corners of a cell, so one prediction serves all three
refined pixels of that cell.  The trees take int32 tensors: the crossed
sum reaches 1020, which uint8 arithmetic would wrap.
"""

from __future__ import annotations

__all__ = [
    "Interpolation",
    "PREDICTORS",
    "check_predictor",
    "tree",
    "tree_crossed",
    "tree_left_top",
    "predictor_tag",
    "predictor_name_for_tag",
]


class Interpolation:
    """Interpolator tags, serde enum order (interpolator.rs:4-9)."""

    CROSSED = 0
    LINE = 1  # metadata-only in the reference (no implementation)
    PREVIOUS = 2


def _avg(a, b):
    """(a + b + 1) >> 1 per pixel (round-half-up; interpolator.rs:41-46)."""
    return (a + b + 1) >> 1


def tree_crossed(tl, tr, bl, br):
    """The exact integer rounding tree of interpolator.rs:41-55."""
    return (_avg(tl, tr) + _avg(bl, br) + _avg(tl, bl) + _avg(tr, br)) >> 2


def tree_left_top(tl, tr, bl, br):
    """LeftTop predictor (interpolator.rs:15-28): the cell origin."""
    return tl


# Values are the predictor ids the CUDA kernels are templated on.
PREDICTORS = {"crossed": 0, "left_top": 1}

_TREES = {"crossed": tree_crossed, "left_top": tree_left_top}

_TAGS = {
    "crossed": Interpolation.CROSSED,
    # left_top has no tag of its own in the reference enum; archives
    # written with it carry the Previous tag, and decode honours it.
    "left_top": Interpolation.PREVIOUS,
}


def check_predictor(name: str) -> str:
    """Normalise a predictor name; ValueError for an unknown one."""
    key = name.lower()
    if key not in PREDICTORS:
        raise ValueError(
            f"unknown predictor {name!r}; expected one of {sorted(PREDICTORS)}"
        )
    return key


def tree(name: str):
    """The rounding tree ``f(tl, tr, bl, br)`` of a predictor."""
    return _TREES[check_predictor(name)]


def predictor_tag(name: str) -> int:
    return _TAGS[check_predictor(name)]


def predictor_name_for_tag(tag: int) -> str:
    """Resolve a container interpolation tag to a predictor name.

    PREVIOUS decodes with left_top (the tag written for left_top
    archives); CROSSED and LINE decode with crossed, as the reference
    decodes everything with Crossed (main.rs:67).
    """
    if tag == Interpolation.PREVIOUS:
        return "left_top"
    return "crossed"
