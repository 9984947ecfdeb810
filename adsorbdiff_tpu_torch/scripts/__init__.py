"""Command lines of the port that are run as ``python -m
adsorbdiff_tpu_torch.scripts.<name>``."""
