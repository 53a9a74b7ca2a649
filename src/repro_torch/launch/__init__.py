"""Command-line launchers, the port of ``repro.launch``: ``serve`` and
``train`` (run as ``python -m repro_torch.launch.serve`` and ``python -m
repro_torch.launch.train``)."""
