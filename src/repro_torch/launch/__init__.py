"""Launchers: ``python -m repro_torch.launch.train`` (one card, or the
ranks of a torchrun group); the one-card accounting ``python -m
repro_torch.launch.dryrun`` / ``sweep`` / ``report`` over ``op_cost``;
``mesh``, the mesh shapes of the spec layer."""
