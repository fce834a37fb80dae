"""The steps, the meshes and the launchers: ``steps.build_steps`` (the
train, prefill and serve steps on one device; with a mesh, the
reference's shardings and ``abstract_state``), ``mesh`` (the production
and local meshes), ``specs`` (meta input stand-ins for every cell),
``python -m repro_torch.launch.train`` and
``python -m repro_torch.launch.serve``."""
