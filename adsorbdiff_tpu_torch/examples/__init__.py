"""The worked examples, ported from the repository's ``examples/``: run as
``python -m adsorbdiff_tpu_torch.examples.<name> [--cpu]``."""
