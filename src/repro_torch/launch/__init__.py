"""Launchers of the port: the solver server (``repro_torch.launch.serve``)
and the LM training driver (``repro_torch.launch.train``)."""
