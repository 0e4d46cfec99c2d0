"""Launchers of the port: the serving launcher (``python -m
repro_torch.launch.serve``)."""
