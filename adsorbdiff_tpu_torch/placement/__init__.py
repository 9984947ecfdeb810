"""Placement toolkit (ref: adsorbdiff/placement/__init__.py); port of
:mod:`adsorbdiff_tpu.placement`."""
from adsorbdiff_tpu_torch.placement.adsorbate import Adsorbate
from adsorbdiff_tpu_torch.placement.adsorbate_slab_config import AdsorbateSlabConfig
from adsorbdiff_tpu_torch.placement.bulk import Bulk
from adsorbdiff_tpu_torch.placement.flag_anomaly import DetectTrajAnomaly
from adsorbdiff_tpu_torch.placement.slab import Slab

__all__ = ["Adsorbate", "AdsorbateSlabConfig", "Bulk", "DetectTrajAnomaly", "Slab"]
