"""The port's model stack: the dense decoder of ``repro.models``.

``api.build_model(cfg)`` returns the model for a config; the dense
decoder (``transformer.DecoderLM``) is ported, the other families raise
``NotImplementedError`` naming their ROADMAP item.
"""
