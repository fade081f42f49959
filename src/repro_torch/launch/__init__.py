"""Command-line entry points: :mod:`repro_torch.launch.cli` behind
``python -m repro_torch``, and the retired ``repro_torch.launch.*`` stubs."""
