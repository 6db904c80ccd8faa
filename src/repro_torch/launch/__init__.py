"""Command-line launchers of the port (counterpart of ``repro/launch``):
so far the serving CLI, ``python -m repro_torch.launch.serve``."""
