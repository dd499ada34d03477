"""Elastic re-meshing: recompute mesh + batch partition after fleet changes.

The JAX package's ``runtime/elastic.py``, the port's own copy (plain
Python).

When the supervisor SHRINKs, the job must keep running with fewer data
replicas: the mesh's data axis shrinks, the global batch is re-balanced
(either smaller global batch or more per-replica microbatching — policy
below keeps the global batch constant via gradient accumulation so the
training trajectory is unchanged), and data shards are reassigned away from
dead hosts deterministically.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    data: int                  # data-parallel replicas
    model: int                 # model shards per replica
    grad_accum: int            # microbatches per step
    shard_owner: Tuple[int, ...]  # data-shard index → host id
    global_batch: int = 0      # effective global batch under this plan


def initial_plan(n_hosts: int, hosts_per_replica: int,
                 global_batch: int) -> MeshPlan:
    data = n_hosts // hosts_per_replica
    assert global_batch % data == 0
    return MeshPlan(data, hosts_per_replica, 1,
                    tuple(r * hosts_per_replica for r in range(data)),
                    global_batch)


def shrink_plan(plan: MeshPlan, dead_hosts: Sequence[int],
                global_batch: int) -> MeshPlan:
    """Drop replicas containing dead hosts; rebalance the batch.

    Policy: keep the global batch exactly when divisibility allows
    (grad_accum over surviving replicas); otherwise keep the *per-replica*
    batch and shrink the global batch to ``new_data × per_replica`` — the
    supervisor rescales the LR by the batch ratio (noted in the audit log).
    """
    dead = set(dead_hosts)
    survivors = [owner for owner in plan.shard_owner
                 if not any(owner <= h < owner + plan.model for h in dead)]
    new_data = len(survivors)
    if new_data == 0:
        raise ValueError("no surviving replicas — RESTART required")
    per_replica = max(global_batch // max(plan.data, 1), 1)
    if global_batch % new_data == 0:
        micro = global_batch // new_data
        accum = max(1, -(-micro // per_replica))
        return MeshPlan(new_data, plan.model, accum, tuple(survivors),
                        global_batch)
    return MeshPlan(new_data, plan.model, 1, tuple(survivors),
                    new_data * per_replica)


def reassign_shards(plan: MeshPlan, n_shards: int) -> Dict[int, List[int]]:
    """Deterministic round-robin of data shards over surviving replicas."""
    owners: Dict[int, List[int]] = {o: [] for o in plan.shard_owner}
    for s in range(n_shards):
        owner = plan.shard_owner[s % plan.data]
        owners[owner].append(s)
    return owners
