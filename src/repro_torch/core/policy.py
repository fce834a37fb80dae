"""The port's own table of vectorized policies, by registry name.

The reference resolves names through ``repro.core.policy``'s registry
(``PolicySpec.jax_factory``); the port keeps its own table of the same
five names and flags (``repro/core/jaxplane.py:530-542``), so it needs
nothing of ``repro``.  A name missing here raises with the catalog.
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

__all__ = ["TORCH_POLICIES", "TorchPolicy", "torch_policies", "make_torch_policy"]

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
