"""PyTorch/CUDA port of :mod:`adsorbdiff_tpu` for NVIDIA Hopper (H100).

The JAX package stays the reference; every module here keeps the name of its
counterpart there (``data/schema.py``, ``ops/pbc.py``, ``models/painn.py``,
...) and keeps its dense padded layout (``AtomsBatch [B, N]``, neighbour
tables ``[B, N, K]``), so intermediates compare one to one.  The package
imports neither ``jax`` nor ``adsorbdiff_tpu``.

Entry points (``collate``, ``PaiNN``, ``DiffusionEngine``) run on the CUDA
card unless the caller passes ``device="cpu"``; with ``device=None`` and no
card they raise (:func:`adsorbdiff_tpu_torch.device.resolve_device`).  The
TPU's Pallas kernels become hand-written Hopper kernels under ``csrc/``, built
on first use by :mod:`adsorbdiff_tpu_torch.ops.build`.

Top-level convenience export mirrors the reference's single public symbol
(``AdsorbDiffCalculator``, ref: adsorbdiff/__init__.py:8), as the JAX package
does.
"""


def __getattr__(name):  # lazy: importing the package loads no model code
    if name == "AdsorbDiffCalculator":
        from adsorbdiff_tpu_torch.relaxation.calculator import AdsorbDiffCalculator

        return AdsorbDiffCalculator
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
