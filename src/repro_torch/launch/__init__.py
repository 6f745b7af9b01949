"""Launchers: ``python -m repro_torch.launch.train``; the one-card
accounting ``python -m repro_torch.launch.dryrun`` / ``sweep`` /
``report`` over ``op_cost``."""
