"""Launchers of the port: the solver server (``repro_torch.launch.serve``),
the LM training loop (``repro_torch.launch.train``), mesh construction
(``repro_torch.launch.mesh``) and placements from logical axes
(``repro_torch.launch.steps``)."""
