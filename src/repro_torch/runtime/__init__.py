from .straggler import ClaimExpiryReissuer, StragglerDetector

__all__ = ["ClaimExpiryReissuer", "StragglerDetector"]
