"""The steps and the launcher: ``steps.build_steps`` (the train, prefill
and serve steps on one device) and ``python -m repro_torch.launch.train``."""
