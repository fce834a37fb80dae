"""The plain fp32 reference and the comparison that decides ``correct``."""
