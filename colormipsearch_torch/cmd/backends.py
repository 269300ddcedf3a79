"""Backend selection for CLI commands: JSON file store or SQLite DB.

Copy of `colormipsearch_tpu/cmd/backends.py`, whose store cache lives as
long as the process. Here it lives as long as one command: `main()`
calls `close_stores()` when a command ends, so a process that runs many
commands (over temporary directories that come and go) never gets a
connection to a store that was deleted since.

The reference picks Mongo vs JSON by configuration
(ColorDepthSearchCmd.getCDMatchesWriter / CalculateGradientScoresCmd
.getCDMatchesReader); here `--db <path>` selects the embedded database,
otherwise the JSON fs layout is used.
"""

from __future__ import annotations

from typing import Optional

from ..dataio import (JSONNeuronMatchesReader, JSONNeuronMatchesWriter,
                      NeuronMatchesReader, NeuronMatchesWriter)
from ..dataio.db import DBNeuronMatchesReader, DBNeuronMatchesWriter

_stores = {}


def get_store(path: str):
    """SQLite by path, Mongo by mongodb:// URI (db_mongo.open_store) —
    both expose the same store surface, so readers/writers are agnostic.
    One connection per path, shared until close_stores()."""
    if path not in _stores:
        from ..dataio.db_mongo import open_store
        _stores[path] = open_store(path)
    return _stores[path]


def close_stores() -> None:
    """Close and forget every store get_store() opened."""
    while _stores:
        _, store = _stores.popitem()
        store.close()


def matches_reader(db: Optional[str],
                   per_masks_dir: Optional[str]) -> NeuronMatchesReader:
    if db:
        return DBNeuronMatchesReader(get_store(db))
    return JSONNeuronMatchesReader(per_masks_dir)


def matches_writer(db: Optional[str], per_masks_dir: Optional[str],
                   per_targets_dir: Optional[str] = None,
                   update_scores_only: bool = False) -> NeuronMatchesWriter:
    if db:
        return DBNeuronMatchesWriter(get_store(db),
                                     update_scores_only=update_scores_only)
    return JSONNeuronMatchesWriter(per_masks_dir, per_targets_dir)
