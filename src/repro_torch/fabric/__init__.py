"""Multi-expander pool fabric (PyTorch port of ``repro.fabric``; DESIGN.md
§11/§13).

Runs N independent pools as one stacked state (``engine.state.
make_pool_stack``: every leaf with a leading expander axis) and routes OSPA
pages to expanders through a pluggable placement layer:

  * ``placement`` — static interleave by page hash, capacity-aware greedy,
    locality-affinity range partition, weighted interleave (skew studies);
    all carry a migration-override table with a batched epoch-apply API;
  * ``ops``       — cross-expander page migration: per-segment stats
    (headroom / eligibility / referenced bits) on the device and the
    batched epoch apply, built from the same §4 mechanism ops as demotion;
  * ``migration`` — the MigrationPolicy layer: freelist-pressure spill,
    traffic-imbalance rebalancing, off;
  * ``replay``    — the segment scheduler: trace partitioning, the
    expanders' masked window replay (``engine.batch``'s window bodies
    unchanged), the double-buffered schedule with a carried pending-page
    mask, the synchronous reference driver, and the sharded driver;
  * ``shard``     — the fabric across ranks (``common.sharding``): the
    plan on the device, the collective apply, the boundary step.
"""
from repro_torch.fabric import migration, ops, placement, replay, shard
from repro_torch.fabric.migration import (MigrationPlan, MigrationPolicy,
                                          NoMigration, SegmentView,
                                          SpillPressure, TrafficRebalance,
                                          make_migration_policy)
from repro_torch.fabric.ops import (apply_migrations, segment_stats,
                                    spill_pages)
from repro_torch.fabric.placement import (CapacityAware, LocalityAffinity,
                                          Placement, StaticInterleave,
                                          WeightedInterleave, make_placement)
from repro_torch.fabric.replay import Fabric, partition_trace

__all__ = [
    "migration", "ops", "placement", "replay", "shard",
    "Placement", "StaticInterleave", "CapacityAware", "LocalityAffinity",
    "WeightedInterleave", "make_placement",
    "MigrationPolicy", "MigrationPlan", "SegmentView", "NoMigration",
    "SpillPressure", "TrafficRebalance", "make_migration_policy",
    "Fabric", "partition_trace", "spill_pages", "apply_migrations",
    "segment_stats",
]
