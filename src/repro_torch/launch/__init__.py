"""Launchers of the port: ``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train`` and ``python -m
repro_torch.launch.dryrun`` (every cell traced on the meta device), the
step functions and their abstract arguments (``steps``), the op count
(``op_analysis``) and the meshes (``mesh``)."""
