"""Adaptive data management (paper §3.1.3 Data Placement + §5.1.4):
object stores with locality, distributed data caching, proactive
migration/staging, and access instrumentation feeding the DataAccessModel.

In the TPU adaptation the same machinery also places *weights* and *KV
caches*: a model's weights are just a (large) object whose locality decides
cold-start cost on a platform.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.behavioral import DataAccessModel


class ObjectStore:
    """One MinIO-like store at a location (platform name or region)."""

    def __init__(self, location: str, capacity_bytes: float = 1e12):
        self.location = location
        self.capacity = capacity_bytes
        self.objects: Dict[str, float] = {}      # key -> size bytes
        self.payloads: Dict[str, object] = {}    # optional real payloads
        self._used = 0.0                         # running byte total

    def put(self, key: str, size: float, payload: object = None):
        old = self.objects.get(key)
        if old is not None:
            self._used -= old
        self.objects[key] = size
        self._used += size
        if payload is not None:
            self.payloads[key] = payload

    def remove(self, key: str):
        size = self.objects.pop(key, None)
        if size is not None:
            self._used -= size
        self.payloads.pop(key, None)

    def has(self, key: str) -> bool:
        return key in self.objects

    def used(self) -> float:
        return self._used


class LRUCache:
    """Distributed data cache layer in front of the stores (§3.1.3 (1))."""

    def __init__(self, capacity_bytes: float):
        self.capacity = capacity_bytes
        self._items: "OrderedDict[str, float]" = OrderedDict()
        self._used = 0.0                         # running byte total

    def get(self, key: str) -> bool:
        if key in self._items:
            self._items.move_to_end(key)
            return True
        return False

    def put(self, key: str, size: float):
        if size > self.capacity:
            return
        old = self._items.pop(key, None)
        if old is not None:
            self._used -= old
        self._items[key] = size
        self._used += size
        while self._used > self.capacity:
            _, evicted = self._items.popitem(last=False)
            self._used -= evicted

    def used(self) -> float:
        return self._used


class DataPlacementManager:
    """Tracks object locations, computes access costs, migrates/stages.

    ``bw[(a, b)]`` is bytes/s between locations (Infiniband vs WAN — the
    paper's bandwidth-heterogeneity point); same-location access uses the
    store's local bandwidth.
    """

    def __init__(self, local_bw: float = 10e9, wan_bw: float = 50e6,
                 cache_enabled: bool = False):
        # Distributed data caching is an FDN *feature* (§3.1.3); it stays
        # OFF by default so baseline reproductions measure raw locality.
        self.cache_enabled = cache_enabled
        self.stores: Dict[str, ObjectStore] = {}
        self.caches: Dict[str, LRUCache] = {}
        self.bw: Dict[Tuple[str, str], float] = {}
        self.local_bw = local_bw
        self.wan_bw = wan_bw
        self.access_model = DataAccessModel()
        self.migrations: int = 0
        self.bytes_migrated: float = 0.0

    # ------------------------------------------------------------ setup ---
    def add_store(self, location: str, capacity: float = 1e12,
                  cache_bytes: float = 1e9) -> ObjectStore:
        st = ObjectStore(location, capacity)
        self.stores[location] = st
        self.caches[location] = LRUCache(cache_bytes)
        return st

    def set_bandwidth(self, a: str, b: str, bytes_per_s: float):
        self.bw[(a, b)] = bytes_per_s
        self.bw[(b, a)] = bytes_per_s

    def _bw(self, a: str, b: str) -> float:
        if a == b:
            return self.local_bw
        return self.bw.get((a, b), self.wan_bw)

    def bandwidth_matrix(self, locations: Sequence[str]) -> np.ndarray:
        """(P, P) bytes/s between ``locations`` (diagonal: local bandwidth).
        The chain planner inverts this into a seconds-per-byte transfer-cost
        matrix, so inter-platform data gravity becomes one array op."""
        names = list(locations)
        n = len(names)
        m = np.empty((n, n))
        for i, a in enumerate(names):
            for j, b in enumerate(names):
                m[i, j] = self._bw(a, b)
        return m

    def transfer_seconds(self, size: float, src: str, dst: str) -> float:
        """Seconds to move ``size`` bytes from ``src`` to ``dst``."""
        return size / self._bw(src, dst)

    # ----------------------------------------------------------- access ---
    def locate(self, key: str, origin: Optional[str] = None) -> \
            Optional[str]:
        """Location of a replica of ``key``; with ``origin`` given, the
        *nearest* replica (highest bandwidth from ``origin``, the origin's
        own store first).  Ties break on store-registration order."""
        locs = [loc for loc, st in self.stores.items() if st.has(key)]
        if not locs:
            return None
        if origin is None:
            return locs[0]
        if origin in locs:
            return origin
        return max(locs, key=lambda l: self._bw(origin, l))

    def locations(self, key: str) -> Set[str]:
        return {loc for loc, st in self.stores.items() if st.has(key)}

    def access_time(self, key: str, from_loc: str) -> float:
        """Seconds to read `key` from a function running at `from_loc`."""
        locs = self.locations(key)
        if not locs:
            return 0.0
        size = max(self.stores[next(iter(locs))].objects[key], 1.0)
        if from_loc in locs:
            return size / self.local_bw
        cache = self.caches.get(from_loc) if self.cache_enabled else None
        if cache is not None and cache.get(key):
            return size / self.local_bw          # cache hit == local
        best = min(locs, key=lambda l: size / self._bw(from_loc, l))
        t = size / self._bw(from_loc, best)
        if cache is not None:                    # write-through cache
            cache.put(key, size)
        return t

    def record_access(self, fn: str, key: str, write: bool = False,
                      count: int = 1):
        """Instrument ``count`` accesses at once (a drained burst makes
        one call per (fn, object) instead of one per invocation)."""
        if write:
            self.access_model.record_write(fn, key, count)
        else:
            self.access_model.record_read(fn, key, count)

    # -------------------------------------------------------- migration ---
    def migrate(self, key: str, to_loc: str):
        """Replicate ``key`` into ``to_loc``'s store, copying from the
        nearest existing replica (no-op if already local)."""
        src = self.locate(key, origin=to_loc)
        if src is None or src == to_loc or to_loc not in self.stores:
            return
        size = self.stores[src].objects[key]
        payload = self.stores[src].payloads.get(key)
        self.stores[to_loc].put(key, size, payload)
        self.migrations += 1
        self.bytes_migrated += size

    def stage_for(self, fn_name: str, objects, to_loc: str):
        """Proactive staging (§3.1.3 (2)) ahead of repeated executions."""
        for key in objects:
            self.migrate(key, to_loc)

    def payload(self, key: str):
        for st in self.stores.values():
            if key in st.payloads:
                return st.payloads[key]
        return None
