"""Tile and strip caches.

Parity: TileCache / StripCache (SURVEY.md §2.1 "Tile & strip caches",
src/lib/core/cache/ [P]):

- TileCache keeps decoded tile images for multi-window / random access
  (strategy flags mirroring GRK_TILE_CACHE_NONE / _ALL)
- strip streaming decodes a whole image in bounded memory, emitting
  horizontal strips through a callback/generator — the gigapixel-decode
  mechanism (SURVEY.md §5 "long-context story")
"""

from __future__ import annotations

import enum
import logging
from collections import OrderedDict

import numpy as np

log = logging.getLogger("grok_tpu_torch")


class TileCacheStrategy(enum.Enum):
    NONE = 0      # no caching: decode on every request
    ALL = 1       # cache every decoded tile (bounded by max_tiles)


class TileCache:
    """LRU cache of decoded tile component planes."""

    def __init__(self, strategy: TileCacheStrategy = TileCacheStrategy.ALL,
                 max_tiles: int = 64):
        self.strategy = strategy
        self.max_tiles = max_tiles
        self._store: OrderedDict[tuple, list[np.ndarray]] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def key(self, tile_index: int, reduce: int, max_layers: int,
            stream_id=None):
        """stream_id ties entries to one codestream so a cache reused
        across decompress() calls on different data cannot serve stale
        tiles (decoders pass a digest of the stream)."""
        return (stream_id, tile_index, reduce, max_layers)

    def get(self, key) -> list[np.ndarray] | None:
        if self.strategy == TileCacheStrategy.NONE:
            return None
        planes = self._store.get(key)
        if planes is not None:
            self.hits += 1
            self._store.move_to_end(key)
            return planes
        self.misses += 1
        return None

    def put(self, key, planes: list[np.ndarray]) -> None:
        if self.strategy == TileCacheStrategy.NONE:
            return
        self._store[key] = planes
        self._store.move_to_end(key)
        while len(self._store) > self.max_tiles:
            self._store.popitem(last=False)

    def clear(self) -> None:
        self._store.clear()
