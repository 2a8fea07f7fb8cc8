"""Launchers of the port: ``python -m repro_torch.launch.serve`` and
``python -m repro_torch.launch.train``, the step functions (``steps``) and
the host mesh (``mesh``)."""
