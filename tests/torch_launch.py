"""Per-engine results of one exact launch of the port, for the tests:
what the JAX package's `drain_deferred` gives for a multi-mask launch,
read from the port's one result API (`MultiMaskScorer.launch_block(...)
.result()`)."""

import numpy as np


def engine_results(scorer, packed, survivors, signal_ranges=None,
                   tile_live=None):
    """[(scores int64 [T], ratios f64 [T], mirrored bool [T])], one per
    engine of `scorer` in its order: the ratios best / query_size, 0 for
    a mask without a query pixel, as ActiveTilePixelEngine.score_packed
    gives them."""
    scores, mirrored = scorer.launch_block(
        packed, survivors, signal_ranges, tile_live).result()
    out = []
    for i, e in enumerate(scorer.engines):
        q = e.tiles.query_size
        ratios = (np.zeros(scores[i].shape, np.float64) if q == 0
                  else scores[i].astype(np.float64) / float(q))
        out.append((scores[i], ratios, mirrored[i]))
    return out
