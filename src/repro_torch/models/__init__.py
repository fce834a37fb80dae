"""The port's model stack: the model families of ``repro.models``.

``api.build_model(cfg)`` returns the model for a config: the decoder
(dense, MoE and VLM), RWKV6, Zamba2 and Whisper, each with its
prefill, decode step and forward-only loss; and the port's own
granite-4.0-h pattern hybrid (prefill and decode step), whose Mamba-2
mixer (``mamba.py``) Zamba2 shares.
"""
