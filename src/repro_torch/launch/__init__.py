"""Launchers (port of ``repro.launch``): so far the training CLI
(``python -m repro_torch.launch.train``)."""
