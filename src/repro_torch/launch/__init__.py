"""Command-line launchers, the port of ``repro.launch``: ``serve`` (run
as ``python -m repro_torch.launch.serve``)."""
