"""The steps, the meshes and the launchers: ``steps.build_steps`` (the
train, prefill and serve steps, on one device or, with a
``DeviceMesh``, sharded on DTensors by the reference's shardings;
``abstract_state``), ``mesh`` (the production and local meshes),
``specs`` (meta input stand-ins for every cell), ``dryrun`` (every
cell's step on meta DTensors under the fake backend:
``python -m repro_torch.launch.dryrun``),
``python -m repro_torch.launch.train`` and
``python -m repro_torch.launch.serve``."""
