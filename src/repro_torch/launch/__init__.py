"""Launchers of the port: the training launcher (``python -m
repro_torch.launch.train``) and the serving launcher (``python -m
repro_torch.launch.serve``)."""
