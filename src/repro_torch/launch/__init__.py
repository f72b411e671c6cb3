"""Command-line entry points of the port: ``python -m
repro_torch.launch.live_train`` (the live runtime, queue or TCP). Importing
this package starts nothing."""
