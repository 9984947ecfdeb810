"""Voronoi-weighted coordination numbers and the surface-atom refinement rule.

Port of :mod:`adsorbdiff_tpu.placement.voronoi`, its arithmetic copied, so that
both packages give the same coordination numbers and tags (numpy and scipy
only: the port keeps its own copy because the JAX
package's :class:`Atoms` reaches JAX through its schema).

Dependency-free rebuild (scipy.spatial + numpy) of the pymatgen-based surface
tagging the reference uses (ref: adsorbdiff/placement/slab.py:385-483):

- ``VoronoiNN(tol=0.1).get_cn(struct, i, use_weights=True)`` computes each
  site's Voronoi facets, weights every neighbor by its facet solid angle
  normalized to the largest facet, drops neighbors with weight <= tol, and
  sums the remaining weights (pymatgen.analysis.local_env semantics).
- ``calculate_coordination_of_bulk_atoms`` (ref: :449-483): the set of
  weighted CNs per element in the bulk (we evaluate every atom instead of
  symmetry-reducing first — the resulting *set* of rounded CNs is identical).
- ``find_surface_atoms_with_voronoi_given_height`` (ref: :385-438): starting
  from height tags, any atom at or above the slab's mass-weighted fractional
  center of mass whose weighted CN is below its element's minimum bulk CN is
  re-tagged as surface.

Periodicity is handled the way pymatgen sees an ASE slab: the cell is fully
periodic (vacuum included), so the Voronoi diagram is built over the 3x3x3
periodic images; across-vacuum facets get near-zero solid angle and fall
under the tol filter by themselves.
"""
from __future__ import annotations

import itertools
from typing import Dict, Optional, Sequence, Set

import numpy as np
from scipy.spatial import Voronoi

from adsorbdiff_tpu_torch.runtime.atoms import Atoms

# Standard atomic masses (amu), index = atomic number (0 is padding).
ATOMIC_MASSES = np.array([
    0.0, 1.008, 4.0026, 6.94, 9.0122, 10.81, 12.011, 14.007, 15.999, 18.998,
    20.180, 22.990, 24.305, 26.982, 28.085, 30.974, 32.06, 35.45, 39.948,
    39.098, 40.078, 44.956, 47.867, 50.942, 51.996, 54.938, 55.845, 58.933,
    58.693, 63.546, 65.38, 69.723, 72.630, 74.922, 78.971, 79.904, 83.798,
    85.468, 87.62, 88.906, 91.224, 92.906, 95.95, 97.0, 101.07, 102.91,
    106.42, 107.87, 112.41, 114.82, 118.71, 121.76, 127.60, 126.90, 131.29,
    132.91, 137.33, 138.91, 140.12, 140.91, 144.24, 145.0, 150.36, 151.96,
    157.25, 158.93, 162.50, 164.93, 167.26, 168.93, 173.05, 174.97, 178.49,
    180.95, 183.84, 186.21, 190.23, 192.22, 195.08, 196.97, 200.59, 204.38,
    207.2, 208.98, 209.0, 210.0, 222.0, 223.0, 226.0, 227.0, 232.04, 231.04,
    238.03, 237.0, 244.0,
])

VORONOI_TOL = 0.1  # pymatgen weight cutoff the reference picks (ref: :425,469)


def _solid_angle(center: np.ndarray, verts: np.ndarray) -> float:
    """Solid angle subtended at ``center`` by the convex planar polygon with
    vertices ``verts`` (Van Oosterom–Strackee over a triangle fan; equals
    pymatgen's spherical-excess ``solid_angle`` on Voronoi facets)."""
    r = verts - center
    n = np.linalg.norm(r, axis=1)
    total = 0.0
    v0, n0 = r[0], n[0]
    for i in range(1, len(r) - 1):
        v1, v2, n1, n2 = r[i], r[i + 1], n[i], n[i + 1]
        num = float(np.dot(v0, np.cross(v1, v2)))
        den = float(n0 * n1 * n2 + np.dot(v0, v1) * n2 + np.dot(v0, v2) * n1 + np.dot(v1, v2) * n0)
        total += 2.0 * abs(np.arctan2(num, den))
    return total


def voronoi_weighted_cns(
    positions: np.ndarray,
    cell: np.ndarray,
    tol: float = VORONOI_TOL,
) -> np.ndarray:
    """Per-atom Voronoi-weighted coordination numbers under full periodicity.

    For each atom: facet solid angles to all Voronoi neighbors over the 3x3x3
    periodic images, weights = angle / max(angle), CN = sum of weights > tol
    (``VoronoiNN.get_cn(..., use_weights=True)``, ref usage: slab.py:425-430).
    """
    pos = np.asarray(positions, np.float64)
    cell = np.asarray(cell, np.float64)
    n = len(pos)
    shifts = [i_a * cell[0] + i_b * cell[1] + i_c * cell[2]
              for i_a, i_b, i_c in itertools.product((-1, 0, 1), repeat=3)]
    # central copy first so point index < n identifies the home image
    shifts.sort(key=lambda s: float(np.dot(s, s)))
    points = np.concatenate([pos + s for s in shifts])
    vor = Voronoi(points)

    angles: list[Dict[int, float]] = [dict() for _ in range(n)]
    for (p, q), verts in zip(vor.ridge_points, vor.ridge_vertices):
        if min(p, q) >= n or -1 in verts:
            continue
        polygon = vor.vertices[verts]
        for site, other in ((p, q), (q, p)):
            if site < n:
                sa = _solid_angle(points[site], polygon)
                angles[site][other] = angles[site].get(other, 0.0) + sa

    cns = np.zeros(n)
    for i, amap in enumerate(angles):
        if not amap:
            continue
        w = np.asarray(list(amap.values()))
        w = w / w.max()
        cns[i] = float(w[w > tol].sum())
    return cns


def calculate_coordination_of_bulk_atoms(bulk_atoms: Atoms) -> Dict[int, Set[float]]:
    """{atomic number: set of weighted CNs present in the bulk}
    (ref: slab.py:449-483; evaluated over all atoms, same CN set)."""
    cns = voronoi_weighted_cns(bulk_atoms.positions, bulk_atoms.cell)
    out: Dict[int, Set[float]] = {}
    for z, cn in zip(np.asarray(bulk_atoms.numbers), cns):
        out.setdefault(int(z), set()).add(round(float(cn), 5))
    return out


def find_surface_atoms_with_voronoi_given_height(
    bulk_atoms: Atoms,
    slab_atoms: Atoms,
    height_tags: Sequence[int],
) -> np.ndarray:
    """Voronoi under-coordination refinement of height tags
    (ref: slab.py:385-438): atoms at/above the mass-weighted fractional COM
    whose weighted CN is below their element's minimum bulk CN become surface."""
    tags = np.asarray(height_tags, np.int64).copy()
    cell = np.asarray(slab_atoms.cell, np.float64)
    frac = slab_atoms.positions @ np.linalg.inv(cell)
    masses = ATOMIC_MASSES[np.clip(np.asarray(slab_atoms.numbers), 0, len(ATOMIC_MASSES) - 1)]
    com_z = float(np.average(frac[:, 2], weights=masses))

    bulk_cn = calculate_coordination_of_bulk_atoms(bulk_atoms)
    slab_cns = voronoi_weighted_cns(slab_atoms.positions, cell)
    numbers = np.asarray(slab_atoms.numbers)
    for idx in range(len(numbers)):
        if tags[idx] == 1 or frac[idx, 2] < com_z:
            continue
        ref_cns = bulk_cn.get(int(numbers[idx]))
        if ref_cns is None:
            tags[idx] = 1  # pathological case tags as surface (ref: :433-435)
            continue
        if round(float(slab_cns[idx]), 5) < min(ref_cns):
            tags[idx] = 1
    return tags
