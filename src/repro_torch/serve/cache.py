"""Solver-state + label-column caches (DESIGN.md §9.2).

Three pieces:

* :class:`NetworkState` — one per network *version*: the raw network, its
  normalization, and the per-node type/offset tables.  The solver engines
  key their prepared device arrays on the identity of the normalized
  network, so holding one ``NetworkState`` per version means operators are
  uploaded once per version, not once per query batch.
* :class:`ColumnCache` — an LRU of solved F-columns keyed by
  ``(version, node)``.  A hit serves with zero LP rounds.  Entries evicted
  by a :class:`~repro_torch.core.GraphDelta` are *demoted* to warm-start hints
  (``stale``): the next solve for that node starts from the stale column
  instead of the seed vector, which is the delta-propagation trick — the
  fixed point moved a little, so the stale answer is a few rounds away.
* :class:`ShardedColumnCache` — N independent ``ColumnCache`` shards, each
  behind its own lock, routed by node id.  The pipelined scheduler's
  assembly and completion stages probe/write concurrently; per-shard locks
  keep eviction and warm-start lookup from serializing on one global
  mutex.  ``shards=1`` is behaviorally identical to a single
  ``ColumnCache`` (tested), so the sharding is purely a concurrency knob.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.network import HeteroNetwork, NormalizedNetwork


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    invalidations: int = 0
    warm_hints: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


@dataclasses.dataclass
class NetworkState:
    """Immutable per-version view of the network."""

    version: int
    net: HeteroNetwork
    norm: NormalizedNetwork
    type_of: np.ndarray
    offsets: List[int]
    sizes: List[int]

    @classmethod
    def from_network(
        cls, net: HeteroNetwork, version: int, norm=None
    ) -> "NetworkState":
        """``norm`` (when the caller already normalized ``net``) keeps the
        normalized-network identity shared — engine ``prepare()`` caches
        are keyed on it (DESIGN.md §11/§13)."""
        if norm is not None and norm.num_nodes != net.num_nodes:
            raise ValueError(
                f"norm has {norm.num_nodes} nodes, network has "
                f"{net.num_nodes} — not a view of this network"
            )
        return cls(
            version=version,
            net=net,
            norm=net.normalize() if norm is None else norm,
            type_of=net.type_of_node(),
            offsets=net.offsets,
            sizes=net.sizes,
        )

    @property
    def num_nodes(self) -> int:
        return self.net.num_nodes

    def local_id(self, node: int) -> Tuple[int, int]:
        """(type, local index) for a global node id."""
        t = int(self.type_of[node])
        return t, node - self.offsets[t]


class ColumnCache:
    """LRU of solved label columns keyed by ``(version, node)``.

    Also keeps, per node, at most one *stale* column from a previous
    version — not servable, but the warm-start seed for the next solve.
    """

    def __init__(
        self,
        capacity: int = 4096,
        *,
        telemetry=None,
        shard_id: Optional[int] = None,
    ):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._lru: "OrderedDict[Tuple[int, int], np.ndarray]" = OrderedDict()
        self._stale: Dict[int, np.ndarray] = {}
        self.stats = CacheStats()
        # mirrors the CacheStats increments into serve.cache.* counters
        # (DESIGN.md §14.2); None = uninstrumented standalone use.  A
        # shard of a ShardedColumnCache additionally mirrors hit/miss
        # into serve.cache.shard<i>.* so per-shard balance is observable.
        self._tel = telemetry
        self._shard_id = shard_id
        # short -> (counter name, per-shard counter name): built once, not
        # per probe
        self._names: Dict[str, Tuple[str, Optional[str]]] = {}

    def __len__(self) -> int:
        return len(self._lru)

    def _count(self, short: str, n: int = 1, *, per_shard: bool = False) -> None:
        tel = self._tel
        if tel is None:
            return
        names = self._names.get(short)
        if names is None:
            shard = (
                None if self._shard_id is None
                else f"serve.cache.shard{self._shard_id}.{short}"
            )
            names = self._names[short] = (f"serve.cache.{short}", shard)
        tel.count(names[0], n)
        if per_shard and names[1] is not None:
            tel.count(names[1], n)

    def get(self, version: int, node: int) -> Optional[np.ndarray]:
        key = (version, node)
        col = self._lru.get(key)
        if col is None:
            self.stats.misses += 1
            self._count("misses", per_shard=True)
            return None
        self._lru.move_to_end(key)
        self.stats.hits += 1
        self._count("hits", per_shard=True)
        return col

    def put(self, version: int, node: int, col: np.ndarray) -> None:
        key = (version, node)
        self._lru[key] = np.asarray(col)
        self._lru.move_to_end(key)
        self._stale.pop(node, None)  # fresh answer supersedes any hint
        while len(self._lru) > self.capacity:
            self._lru.popitem(last=False)
            self.stats.evictions += 1
            self._count("evictions")

    # ---------------------------------------------------------- warm starts
    def stale_hint(self, node: int) -> Optional[np.ndarray]:
        return self._stale.get(node)

    def stale_nodes(self) -> List[int]:
        """Nodes currently holding a demoted warm-start hint."""
        return list(self._stale)

    def put_stale(self, node: int, col: np.ndarray) -> None:
        """Replace a node's hint (serve's post-delta refresh writes back)."""
        self._stale[node] = np.asarray(col)

    def cached_nodes(self, version: int) -> List[int]:
        return [n for (v, n) in self._lru if v == version]

    def snapshot(self, version: int) -> List[Tuple[int, np.ndarray]]:
        """Stats-neutral read of one version's columns (FT checkpoint).

        Unlike ``get`` this neither bumps hit counters nor touches LRU
        order — a periodic checkpoint must not distort the hit-rate SLO
        or promote cold entries."""
        return [(n, col) for (v, n), col in self._lru.items() if v == version]

    # --------------------------------------------------------- invalidation
    def invalidate_for_delta(
        self,
        old_version: int,
        new_version: int,
        touched_types: frozenset,
        type_of: np.ndarray,
        remap=None,
        carry_untouched: bool = True,
    ) -> int:
        """Apply a version bump.

        Columns of *touched* types are demoted to stale warm-start hints
        (optionally passed through ``remap`` when the node id space grew).
        Columns of untouched types are carried into the new version when
        ``carry_untouched`` (the freshness/latency trade documented in
        DESIGN.md §9.3) unless ``remap`` is set — a re-shaped id space means
        every cached column has the wrong length, so everything demotes.
        Returns the number of demoted columns.
        """
        demoted = 0
        old_items = [
            ((v, n), col) for (v, n), col in self._lru.items() if v == old_version
        ]
        for (v, n), col in old_items:
            del self._lru[(v, n)]
            touched = int(type_of[n]) in touched_types
            if remap is None and carry_untouched and not touched:
                self._lru[(new_version, n)] = col
                continue
            hint = col if remap is None else remap(col)
            self._stale[n] = hint
            self.stats.invalidations += 1
            demoted += 1
        self.stats.warm_hints = len(self._stale)
        if demoted:
            self._count("invalidations", demoted)
        return demoted

    def invalidate_newer(self, version: int) -> int:
        """Drop every column published after ``version`` (FT restore).

        After a restore to a checkpoint watermark, columns computed past
        the watermark may carry state from the failed execution — they
        are dropped outright, not demoted: a tainted column must not even
        warm-start the replay.  Stale hints predating the watermark keep
        their (versionless) warm-start role.  Returns the drop count.
        """
        doomed = [(v, n) for (v, n) in self._lru if v > version]
        for key in doomed:
            del self._lru[key]
        if doomed:
            self.stats.invalidations += len(doomed)
            self._count("invalidations", len(doomed))
        return len(doomed)

    def clear(self) -> None:
        self._lru.clear()
        self._stale.clear()


class ShardedColumnCache:
    """``ColumnCache`` split into N independently-locked shards.

    Keys route by ``node % shards`` (the version is deliberately NOT in
    the routing key, so a node's fresh columns and its stale warm-start
    hint always live in the same shard).  Each shard holds
    ``ceil(capacity / shards)`` columns, so total capacity is preserved
    and, with one shard, eviction order is identical to the flat LRU.

    Exposes the same surface as :class:`ColumnCache` — the serve engine
    treats the two interchangeably — plus an aggregated ``stats`` view.
    """

    def __init__(
        self, capacity: int = 4096, *, shards: int = 1, telemetry=None
    ):
        if shards < 1:
            raise ValueError("shards must be >= 1")
        if capacity < shards:
            raise ValueError(
                f"capacity {capacity} < shards {shards}: every shard "
                "needs at least one slot"
            )
        self.capacity = capacity
        self.shards = shards
        per_shard = -(-capacity // shards)  # ceil
        self._shards: List[ColumnCache] = [
            ColumnCache(
                per_shard,
                telemetry=telemetry,
                shard_id=(i if shards > 1 else None),
            )
            for i in range(shards)
        ]
        self._locks = [threading.Lock() for _ in range(shards)]

    def _shard(self, node: int) -> Tuple[ColumnCache, threading.Lock]:
        i = node % self.shards
        return self._shards[i], self._locks[i]

    def __len__(self) -> int:
        return sum(len(s) for s in self._shards)

    @property
    def stats(self) -> CacheStats:
        """Aggregated snapshot across shards (same fields as the flat LRU)."""
        agg = CacheStats()
        for s in self._shards:
            agg.hits += s.stats.hits
            agg.misses += s.stats.misses
            agg.evictions += s.stats.evictions
            agg.invalidations += s.stats.invalidations
            agg.warm_hints += s.stats.warm_hints
        return agg

    def shard_stats(self) -> List[CacheStats]:
        return [s.stats for s in self._shards]

    def get(self, version: int, node: int) -> Optional[np.ndarray]:
        shard, lock = self._shard(node)
        with lock:
            return shard.get(version, node)

    def put(self, version: int, node: int, col: np.ndarray) -> None:
        shard, lock = self._shard(node)
        with lock:
            shard.put(version, node, col)

    def stale_hint(self, node: int) -> Optional[np.ndarray]:
        shard, lock = self._shard(node)
        with lock:
            return shard.stale_hint(node)

    def put_stale(self, node: int, col: np.ndarray) -> None:
        shard, lock = self._shard(node)
        with lock:
            shard.put_stale(node, col)

    def stale_nodes(self) -> List[int]:
        out: List[int] = []
        for shard, lock in zip(self._shards, self._locks):
            with lock:
                out.extend(shard.stale_nodes())
        return out

    def cached_nodes(self, version: int) -> List[int]:
        out: List[int] = []
        for shard, lock in zip(self._shards, self._locks):
            with lock:
                out.extend(shard.cached_nodes(version))
        return out

    def snapshot(self, version: int) -> List[Tuple[int, np.ndarray]]:
        out: List[Tuple[int, np.ndarray]] = []
        for shard, lock in zip(self._shards, self._locks):
            with lock:
                out.extend(shard.snapshot(version))
        return out

    def invalidate_for_delta(
        self,
        old_version: int,
        new_version: int,
        touched_types: frozenset,
        type_of: np.ndarray,
        remap=None,
        carry_untouched: bool = True,
    ) -> int:
        demoted = 0
        for shard, lock in zip(self._shards, self._locks):
            with lock:
                demoted += shard.invalidate_for_delta(
                    old_version,
                    new_version,
                    touched_types,
                    type_of,
                    remap=remap,
                    carry_untouched=carry_untouched,
                )
        return demoted

    def invalidate_newer(self, version: int) -> int:
        dropped = 0
        for shard, lock in zip(self._shards, self._locks):
            with lock:
                dropped += shard.invalidate_newer(version)
        return dropped

    def clear(self) -> None:
        for shard, lock in zip(self._shards, self._locks):
            with lock:
                shard.clear()
