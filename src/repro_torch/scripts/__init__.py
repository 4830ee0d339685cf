"""Ports of the reference's ``scripts/`` tools, each runnable as
``python -m repro_torch.scripts.<name>`` (what runs kernels runs them on
the card; ``--cpu`` runs their plain versions on the host)."""
