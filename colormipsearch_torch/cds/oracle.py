"""The xy-shift ring of the pixel match.

Copy of `shift_ring_offsets` from `colormipsearch_tpu/cds/oracle.py`
(:152-171); the rest of that module (the pure-NumPy pixel oracle) is not
part of this package. `tests/test_torch_host_copies.py` pins it equal to
the reference.
"""

from __future__ import annotations


def shift_ring_offsets(xyshift: int) -> list:
    """(dx, dy) shift variants for an even xyshift.

    The reference emits, for each ring i in {2,4,..,xyshift}, the 9 combos
    xx,yy in {-i,0,i} INCLUDING (0,0) (PixelMatchColorDepthSearchAlgorithm
    .java:113-130) — but sizes the array as 1+(xyshift/2)*8, which only
    holds for xyshift in {0, 2}; xyshift >= 4 overflows in the reference.
    We generalize: rings of 8 offsets plus a single (0,0), which is
    identical to the reference for xyshift in {0, 2} (the production and
    golden-test settings) and well-defined beyond.
    """
    if xyshift % 2 == 1:
        raise ValueError("XY shift parameter must be an even number.")
    offsets = [(0, 0)]
    for i in range(2, xyshift + 1, 2):
        for xx in (-i, 0, i):
            for yy in (-i, 0, i):
                if (xx, yy) != (0, 0):
                    offsets.append((xx, yy))
    return offsets
