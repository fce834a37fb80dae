"""Elastic mesh planning: re-fit the (data, model) mesh to survivors
(the port's own copy of ``repro.runtime.elastic``).

Model parallel groups must stay intact (a dead host inside a TP group
kills the whole group's shard coherence), so the plan keeps the 'model'
axis size fixed and shrinks 'data' (and 'pod') to the largest multiple
that survivors can fill; leftover hosts become hot spares.  Restore then
reshards the checkpoint onto the new mesh (checkpoint/ckpt.py handles
arbitrary re-sharding).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

__all__ = ["ElasticPlan", "plan_elastic_mesh"]


@dataclass
class ElasticPlan:
    data: int
    model: int
    pod: int
    used_hosts: List[int]
    spares: List[int]

    @property
    def n_used(self) -> int:
        return self.data * self.model * self.pod


def plan_elastic_mesh(
    survivors: List[int],
    model_size: int,
    devices_per_host: int = 1,
    pods: int = 1,
) -> Optional[ElasticPlan]:
    """Largest (pod, data, model) mesh fillable by survivor devices.

    Returns None when survivors cannot fill even one model group (the run
    must wait for replacements — better than silently degrading TP)."""
    n_dev = len(survivors) * devices_per_host
    group = model_size * pods  # one data-slice across all pods
    data = n_dev // group
    if data < 1:
        return None
    used = data * group
    used_hosts = survivors[: used // devices_per_host]
    spares = survivors[used // devices_per_host:]
    return ElasticPlan(data=data, model=model_size, pod=pods,
                       used_hosts=used_hosts, spares=spares)
