"""Ports of the reference's ``examples/`` scripts, each runnable as
``python -m repro_torch.examples.<name>`` (on the card; ``--cpu`` runs the
kernels' plain versions on the host)."""
