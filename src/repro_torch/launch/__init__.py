"""Launchers of the port: the solver server (``repro_torch.launch.serve``)."""
