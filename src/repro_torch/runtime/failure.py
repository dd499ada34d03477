"""Failure detection + recovery policy for 1000+-node fleets.

The JAX package's ``runtime/failure.py``, the port's own copy (plain
Python: no module of the port imports the JAX package).

Pure-function policy core + a simulation-friendly registry, so that tests
can drive it without a real cluster:

* ``HeartbeatRegistry`` — hosts report beats; ``missing(now)`` lists hosts
  past the timeout.
* ``decide_recovery`` — the supervisor policy: given fleet state, choose
  CONTINUE / SHRINK (elastic re-mesh without the dead hosts; data shards
  rebalanced) / RESTART (reload latest checkpoint; used when too many hosts
  died for a consistent shrink or a mesh axis can't be re-factored).
* ``StragglerTracker`` — per-host step-time EMA; hosts slower than
  ``threshold × median`` get flagged; policy first reassigns their data
  shard, then evicts on repeat offenses.

tests/test_runtime.py (and tests/test_torch_train.py on this copy) drive these through failure scripts (mid-step death,
cascades, flapping stragglers) and asserts invariants: work is never
assigned to dead hosts, shrink keeps the batch divisible, restart always
lands on a manifest-complete step.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple


class Action(enum.Enum):
    CONTINUE = "continue"
    SHRINK = "shrink"
    RESTART = "restart"


@dataclasses.dataclass
class RecoveryPlan:
    action: Action
    healthy_hosts: Tuple[int, ...]
    new_data_parallel: Optional[int] = None   # replicas after shrink
    reason: str = ""


class HeartbeatRegistry:
    def __init__(self, hosts: Sequence[int], timeout_s: float = 60.0):
        self.timeout = timeout_s
        self.last_beat: Dict[int, float] = {h: 0.0 for h in hosts}

    def beat(self, host: int, now: Optional[float] = None) -> None:
        self.last_beat[host] = time.time() if now is None else now

    def missing(self, now: Optional[float] = None) -> List[int]:
        t = time.time() if now is None else now
        return sorted(h for h, b in self.last_beat.items()
                      if t - b > self.timeout)

    def healthy(self, now: Optional[float] = None) -> List[int]:
        dead = set(self.missing(now))
        return sorted(h for h in self.last_beat if h not in dead)


def decide_recovery(
    n_hosts: int,
    dead: Sequence[int],
    *,
    hosts_per_replica: int,
    n_replicas: int,
    max_shrink_fraction: float = 0.25,
) -> RecoveryPlan:
    """Supervisor policy after failures.

    A data-parallel *replica* spans ``hosts_per_replica`` hosts (the model
    shards).  Losing any host kills its whole replica; the fleet can shrink
    by dropping dead replicas while > (1−max_shrink_fraction) capacity
    remains, otherwise it restarts from checkpoint waiting for replacements.
    """
    dead_set = set(dead)
    healthy = tuple(h for h in range(n_hosts) if h not in dead_set)
    if not dead_set:
        return RecoveryPlan(Action.CONTINUE, healthy, n_replicas, "no failures")

    dead_replicas = {h // hosts_per_replica for h in dead_set}
    alive_replicas = n_replicas - len(dead_replicas)
    if alive_replicas <= 0:
        return RecoveryPlan(Action.RESTART, healthy, None,
                            "all replicas affected")
    lost_frac = len(dead_replicas) / n_replicas
    if lost_frac <= max_shrink_fraction:
        return RecoveryPlan(
            Action.SHRINK, healthy, alive_replicas,
            f"dropping {len(dead_replicas)} replica(s), "
            f"{alive_replicas}/{n_replicas} remain")
    return RecoveryPlan(Action.RESTART, healthy, None,
                        f"{lost_frac:.0%} of replicas lost "
                        f"> {max_shrink_fraction:.0%} shrink budget")


class StragglerTracker:
    """Per-host step-time EMA with median-relative flagging."""

    def __init__(self, alpha: float = 0.2, threshold: float = 1.5,
                 evict_after: int = 3):
        self.alpha = alpha
        self.threshold = threshold
        self.evict_after = evict_after
        self.ema: Dict[int, float] = {}
        self.offenses: Dict[int, int] = defaultdict(int)

    def record(self, host: int, step_time: float) -> None:
        prev = self.ema.get(host)
        self.ema[host] = (step_time if prev is None
                          else self.alpha * step_time + (1 - self.alpha) * prev)

    def stragglers(self) -> List[int]:
        if len(self.ema) < 2:
            return []
        times = sorted(self.ema.values())
        median = times[len(times) // 2]
        out = []
        for h, t in self.ema.items():
            if t > self.threshold * median:
                self.offenses[h] += 1
                out.append(h)
        return sorted(out)

    def to_evict(self) -> List[int]:
        return sorted(h for h, c in self.offenses.items()
                      if c >= self.evict_after)
