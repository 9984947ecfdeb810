"""Bulk representation (ref: adsorbdiff/placement/bulk.py:36-130).

Port of :mod:`adsorbdiff_tpu.placement.bulk`, its arithmetic copied, so that
the same ``np.random.Generator`` seed gives the same result in both packages
(numpy and scipy only: the port keeps its own copy because the JAX
package's :class:`Atoms` reaches JAX through its schema).
"""
from __future__ import annotations

import pickle
from typing import List, Optional

import numpy as np

from adsorbdiff_tpu_torch.runtime.atoms import Atoms


class Bulk:
    def __init__(
        self,
        bulk_atoms: Optional[Atoms] = None,
        bulk_id_from_db: Optional[int] = None,
        bulk_db_path: Optional[str] = None,
        src_id: Optional[str] = None,
        rng: Optional[np.random.Generator] = None,
    ) -> None:
        self.src_id = src_id
        self.bulk_id_from_db = bulk_id_from_db
        if bulk_atoms is not None:
            self.atoms = bulk_atoms
        else:
            assert bulk_db_path is not None, "need atoms or a db path"
            with open(bulk_db_path, "rb") as f:
                db = pickle.load(f)
            if bulk_id_from_db is None:
                rng = rng or np.random.default_rng()
                bulk_id_from_db = int(rng.integers(len(db)))
                self.bulk_id_from_db = bulk_id_from_db
            entry = db[bulk_id_from_db]
            atoms = entry[0] if isinstance(entry, (tuple, list)) else entry
            self.atoms = Atoms.from_ase(atoms) if not isinstance(atoms, Atoms) else atoms
            if isinstance(entry, (tuple, list)) and len(entry) > 1:
                self.src_id = entry[1]

    def get_slabs(self, max_miller: int = 2, precomputed_slabs_dir: Optional[str] = None) -> List:
        """All slabs up to max_miller (ref: bulk.py:85-111)."""
        from adsorbdiff_tpu_torch.placement.slab import Slab, enumerate_millers

        slabs = []
        for millers in enumerate_millers(max_miller):
            slabs += Slab.from_bulk_get_specific_millers(millers, self)
        return slabs

    def __len__(self) -> int:
        return len(self.atoms)

    def __repr__(self) -> str:
        return f"Bulk: (src_id={self.src_id}, natoms={len(self)})"
