"""The port's own table of vectorized policies, by registry name.

The reference resolves names through ``repro.core.policy``'s registry
(``PolicySpec.jax_factory``); the port keeps its own table of the same
five names and flags (``repro/core/jaxplane.py:530-542``), and its own
copy of each policy's serving and overload presets
(``repro/core/policy.py:450-541``), so it needs nothing of ``repro``.
A name missing here raises with the catalog.
"""

from __future__ import annotations

from typing import List

from .torchplane import (
    TorchPolicy,
    _next_batch_adaptive,
    _next_batch_cap,
    _select_rss,
    _select_shared,
)

__all__ = [
    "TORCH_POLICIES",
    "TorchPolicy",
    "torch_policies",
    "make_torch_policy",
    "serving_defaults",
    "overload_defaults",
]

TORCH_POLICIES = {
    "corec": TorchPolicy("corec", True, False, _select_shared, _next_batch_cap),
    "scaleout": TorchPolicy("scaleout", False, False, _select_rss, _next_batch_cap),
    "locked": TorchPolicy(
        "locked", True, True, _select_shared, _next_batch_cap, leases=False
    ),
    "hybrid": TorchPolicy(
        "hybrid", False, False, _select_rss, _next_batch_cap, steals=True
    ),
    "adaptive-batch": TorchPolicy(
        "adaptive-batch", True, False, _select_shared, _next_batch_adaptive
    ),
}


#: the baseline serving knobs of the shared-queue disciplines; per-worker
#: queues carry ~1/N of the admission budget (N = 4, the reference pool)
_SERVING_SHARED = {"admit_limit": 96.0, "base_workers": 2.0, "scale_backlog": 48.0}
_SERVING_PERQUEUE = {"admit_limit": 24.0, "base_workers": 2.0, "scale_backlog": 12.0}

#: graceful-degradation overload presets: bounded retries with backoff
#: and jitter, a breaker on a stale queue head, and an admission depth
#: matched to the client deadline (per-worker queues: ~1/N of it)
_GRACEFUL_SHARED = {
    "timeout": 2.0,
    "retries": 2,
    "backoff": 4.0,
    "jitter": 1.0,
    "breaker_age": 0.5,
    "admit_limit": 2.0,
}
_GRACEFUL_PERQUEUE = dict(_GRACEFUL_SHARED, admit_limit=1.0)

_PER_QUEUE = ("scaleout", "hybrid")


def serving_defaults(name: str) -> dict:
    """The policy's baseline serving knobs (a fresh, mergeable dict)."""
    make_torch_policy(name)
    return dict(_SERVING_PERQUEUE if name in _PER_QUEUE else _SERVING_SHARED)


def overload_defaults(name: str) -> dict:
    """The policy's graceful-degradation overload preset (a fresh dict)."""
    make_torch_policy(name)
    return dict(_GRACEFUL_PERQUEUE if name in _PER_QUEUE else _GRACEFUL_SHARED)


def torch_policies() -> List[str]:
    """Policy names that run on the torch plane."""
    return sorted(TORCH_POLICIES)


def make_torch_policy(name: str) -> TorchPolicy:
    """Resolve a policy name; an unknown one raises with the catalog."""
    try:
        return TORCH_POLICIES[name]
    except KeyError:
        raise ValueError(
            f"policy {name!r} has no torch-plane analogue; "
            f"vectorized: {torch_policies()}"
        ) from None


def _fused_requests(seeds, lane_params=None, policies=None, **knob_dicts):
    """One request dict per policy for the fused lane engine.

    The sweep convention of ``repro.core.policy._fused_requests``:
    ``adaptive-batch``'s swept knob is its clamp, so when ``lane_params``
    sweeps ``batch`` and gives no ``max_batch``, the batch axis is
    mirrored into ``max_batch`` for that policy.  Extra keyword dicts
    (``traffic_params=...``, ``fault_params=...``) pass through.
    """
    names = torch_policies() if policies is None else list(policies)
    requests = []
    for name in names:
        lp = dict(lane_params or {})
        if name == "adaptive-batch" and "batch" in lp and "max_batch" not in lp:
            lp["max_batch"] = lp["batch"]
        req = {"policy": name, "seeds": seeds, "lane_params": lp}
        for key, val in knob_dicts.items():
            req[key] = dict(val) if val else {}
        requests.append(req)
    return requests
