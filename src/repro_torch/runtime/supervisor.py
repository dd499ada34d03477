"""Training supervisor: the fault-tolerant outer loop.

The JAX package's ``runtime/supervisor.py`` driving the port's step
function: the state is a torch tree (``CheckpointManager`` copies it to
host numpy itself when it saves).

Composes the substrate pieces — data loader, jitted train step, async
checkpointing, heartbeat/straggler policies, elastic re-mesh — into the
loop a real cluster controller would run per job:

    restore-from-latest → train → [failure?] → decide → shrink/restart → …

Failures are injected via the ``fault_hook`` callback (tests script them);
on real hardware the same decision points would be fed by the heartbeat
service instead.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.runtime.elastic import initial_plan, shrink_plan
from repro_torch.runtime.failure import (Action, HeartbeatRegistry,
                                         StragglerTracker, decide_recovery)


@dataclasses.dataclass
class SupervisorConfig:
    total_steps: int
    ckpt_every: int = 50
    ckpt_dir: str = "repro_ckpt"
    n_hosts: int = 1
    hosts_per_replica: int = 1
    heartbeat_timeout_s: float = 60.0


class Supervisor:
    def __init__(self, cfg: SupervisorConfig, *,
                 init_state: Callable[[], Dict],
                 step_fn: Callable[[Dict, Dict], Dict],
                 batch_fn: Callable[[int], Dict],
                 fault_hook: Optional[Callable[[int], list]] = None):
        """
        init_state: () → train-state tree (tensors)
        step_fn:    (state, batch) → state
        batch_fn:   step → host-local batch
        fault_hook: step → list of host ids that died this step (simulation)
        """
        self.cfg = cfg
        self.init_state = init_state
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.fault_hook = fault_hook or (lambda step: [])
        self.ckpt = CheckpointManager(cfg.ckpt_dir)
        self.heartbeats = HeartbeatRegistry(range(cfg.n_hosts),
                                            cfg.heartbeat_timeout_s)
        self.stragglers = StragglerTracker()
        self.plan = initial_plan(cfg.n_hosts, cfg.hosts_per_replica,
                                 global_batch=max(cfg.n_hosts, 1))
        self.events: list = []   # audit log consumed by tests

    def run(self) -> Dict:
        state = self.init_state()
        start = 0
        latest = self.ckpt.latest_step()
        if latest is not None:
            state, start = self.ckpt.restore(state, latest)
            self.events.append(("restored", latest))
            start = latest + 1

        step = start
        restarts = 0
        while step < self.cfg.total_steps:
            t0 = time.time()
            dead = self.fault_hook(step)
            if dead:
                plan = decide_recovery(
                    self.cfg.n_hosts, dead,
                    hosts_per_replica=self.cfg.hosts_per_replica,
                    n_replicas=self.plan.data)
                self.events.append(("failure", step, tuple(dead), plan.action))
                if plan.action is Action.SHRINK:
                    self.plan = shrink_plan(self.plan, dead,
                                            global_batch=max(self.cfg.n_hosts, 1))
                    self.events.append(("shrunk", step, self.plan.data))
                elif plan.action is Action.RESTART:
                    restarts += 1
                    self.ckpt.wait()
                    latest = self.ckpt.latest_step()
                    if latest is not None:
                        state = self.init_state()
                        state, _ = self.ckpt.restore(state, latest)
                        step = latest + 1
                    else:
                        state = self.init_state()
                        step = 0
                    self.events.append(("restarted", step))
                    continue

            batch = self.batch_fn(step)
            state = self.step_fn(state, batch)
            self.stragglers.record(0, time.time() - t0)

            if step % self.cfg.ckpt_every == 0 and step > 0:
                self.ckpt.save(step, state)
                self.events.append(("saved", step))
            step += 1

        self.ckpt.wait()
        self.events.append(("done", step, restarts))
        return state
