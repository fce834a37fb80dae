"""The port's model stack: the model families of ``repro.models``.

``api.build_model(cfg)`` returns the model for a config: the decoder
(dense and VLM), RWKV6, Zamba2 and Whisper are ported; the MoE
configurations raise ``NotImplementedError`` naming their ROADMAP item.
"""
