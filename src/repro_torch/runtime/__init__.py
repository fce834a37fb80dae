from .fault import FailureDetector, HeartbeatTable, SimCluster
from .straggler import ClaimExpiryReissuer, StragglerDetector
from .elastic import plan_elastic_mesh

__all__ = [
    "FailureDetector",
    "HeartbeatTable",
    "SimCluster",
    "ClaimExpiryReissuer",
    "StragglerDetector",
    "plan_elastic_mesh",
]
