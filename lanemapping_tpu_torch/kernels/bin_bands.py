"""The band plan of the binning kernels K1 and K1z (`csrc/bin_bands.cuh`).

Both kernels bucket the points of B tiles by band, then give each band one
CTA that accumulates it in shared memory and writes its outputs once.  A
band is ``rows_per_band`` rows by ``x_chunk`` columns of one tile's
[height, width] grid, each (row, column) holding ``depth`` cells of
``n_vals`` sums and one count.  ``band_plan`` decides the split here, in
plain Python, so that the CPU tests reach it; the CUDA code only follows
it.  A band spans whole rows, or one row cut into x-chunks when one row
does not fit the budget, so its cells are one contiguous stretch of a
row-major output.  Between the passes each binned point is a record of
``rec`` floats in its band's segment of the scratch.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import numpy as np
import torch

SMEM_LIMIT = 232448        # dynamic shared memory one CTA may have on H100
BAND_BUDGET = 40 * 1024    # target shared memory of a band: 5 CTAs per SM
HIST_BUDGET = 48 * 1024    # (C) keeps three ints per band of a tile
POINTS_PER_CTA = 256 * 16  # bins::BLOCK * bins::PPT of passes (A) and (C)
# the scratch of a launch, in the order of the kernels' C arguments
SCRATCH = ("band_count", "band_off", "band_cursor", "slot_rec")


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def band_smem_bytes(cells: int, n_vals: int) -> int:
    """Shared memory of pass (D) for ``cells`` cells: sums padded to 16
    bytes, then counts, all float32."""
    return 4 * (_ceil_div(cells * n_vals, 4) * 4 + cells)


@dataclasses.dataclass(frozen=True)
class BandPlan:
    n_tiles: int
    n_points: int
    height: int
    width: int
    depth: int
    n_vals: int
    rec: int
    rows_per_band: int
    x_chunk: int
    n_xchunks: int
    bands_per_tile: int

    @property
    def n_bands(self) -> int:
        return self.n_tiles * self.bands_per_tile

    @property
    def cells_per_band(self) -> int:
        return self.rows_per_band * self.x_chunk * self.depth

    @property
    def smem_bytes(self) -> int:
        """Shared memory per CTA of pass (D)."""
        return band_smem_bytes(self.cells_per_band, self.n_vals)

    @property
    def hist_smem_bytes(self) -> int:
        """Band bookkeeping per CTA of pass (C): count, first slot and
        first sorted position of each band of a tile."""
        return 12 * self.bands_per_tile

    @property
    def scatter_smem_bytes(self) -> int:
        """Shared memory per CTA of pass (C): the CTA's records sorted by
        band, their bands, and the band bookkeeping."""
        return 4 * POINTS_PER_CTA * (self.rec + 1) + self.hist_smem_bytes

    @property
    def n_slots(self) -> int:
        """Record slots: every point of every tile, the worst case."""
        return self.n_tiles * self.n_points

    def band_rect(self, k: int) -> Tuple[int, int, int, int]:
        """Band ``k`` of a tile: (first row, rows, first column, columns)."""
        r0 = (k // self.n_xchunks) * self.rows_per_band
        x0 = (k % self.n_xchunks) * self.x_chunk
        return (r0, min(self.rows_per_band, self.height - r0), x0,
                min(self.x_chunk, self.width - x0))

    def locate(self, row: np.ndarray, col: np.ndarray, sub: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(band within the tile, cell index within the band) of cells, as
        ``bins::BandGeom::band`` and ``local`` compute them."""
        band = (row // self.rows_per_band) * self.n_xchunks \
            + col // self.x_chunk
        local = ((row % self.rows_per_band) * self.x_chunk
                 + col % self.x_chunk) * self.depth + sub
        return band, local

    def kernel_args(self) -> Tuple[int, ...]:
        return (self.rows_per_band, self.x_chunk, self.n_xchunks,
                self.bands_per_tile, self.smem_bytes, self.rec)

    def scratch(self, device) -> Dict[str, torch.Tensor]:
        """Band counts, offsets and cursors, and the record slots, sized for
        the worst case (every point binned): no host sync sizes them."""
        n = self.n_bands
        ints = torch.empty(3 * n + 1, dtype=torch.int32, device=device)
        return {"band_count": ints[:n], "band_off": ints[n:2 * n + 1],
                "band_cursor": ints[2 * n + 1:],
                "slot_rec": torch.empty(self.n_slots * self.rec,
                                        dtype=torch.float32, device=device)}


def _split(height: int, width: int, depth: int, n_vals: int, budget: int
           ) -> Tuple[int, int, int]:
    """(rows_per_band, x_chunk, n_xchunks) within ``budget`` bytes (k rows
    or columns never take more than k times one of them)."""
    row_bytes = band_smem_bytes(width * depth, n_vals)
    if row_bytes <= budget:
        rows = min(height, budget // row_bytes)
        rows = _ceil_div(height, _ceil_div(height, rows))  # even bands
        return rows, width, 1
    x_chunk = max(1, budget // band_smem_bytes(depth, n_vals))
    x_chunk = _ceil_div(width, _ceil_div(width, x_chunk))  # even chunks
    return 1, x_chunk, _ceil_div(width, x_chunk)


@functools.lru_cache(maxsize=64)
def band_plan(n_tiles: int, n_points: int, height: int, width: int,
              depth: int = 1, n_vals: int = 1, rec: int = 2) -> BandPlan:
    """The bands of a [height, width, depth] grid with ``n_vals`` sums per
    cell, for ``n_tiles`` tiles of ``n_points`` points each, whose records
    are ``rec`` floats (a power of two: K1's [value, cell index] is 2,
    K1z's record is the point itself).

    Bands are as large as ``BAND_BUDGET`` bytes of shared memory allow:
    whole rows while a row fits, else one row in even x-chunks.  When a
    tile has too many bands for pass (C)'s bookkeeping, the budget grows to
    the card's limit.  Raises where even that does not fit: pass (C) holds
    4,096 records in shared memory, so ``rec`` is at most 8 (K1z takes at
    most 8 columns).  Plans are cached by their arguments."""
    if min(height, width, depth, n_vals) < 1 or min(n_tiles, n_points) < 0:
        raise ValueError(f"bad grid {height}x{width}x{depth}, n_vals "
                         f"{n_vals}, {n_tiles} tiles of {n_points} points")
    if rec < 2 or rec & (rec - 1):
        raise ValueError(f"binning: record of {rec} floats, not a power of "
                         f"two >= 2")
    if n_tiles * n_points * rec >= 2 ** 31:
        raise ValueError("binning: B * N records must fit in int32")
    for b in (BAND_BUDGET, SMEM_LIMIT):
        rows, x_chunk, n_xchunks = _split(height, width, depth, n_vals, b)
        plan = BandPlan(n_tiles, n_points, height, width, depth, n_vals,
                        rec, rows, x_chunk, n_xchunks,
                        _ceil_div(height, rows) * n_xchunks)
        if plan.hist_smem_bytes <= HIST_BUDGET:
            break
    if max(plan.smem_bytes, plan.scatter_smem_bytes) > SMEM_LIMIT:
        raise ValueError(
            f"binning: a {height}x{width}x{depth} grid with {n_vals} values "
            f"per cell needs {plan.smem_bytes} B per band and "
            f"{plan.scatter_smem_bytes} B per scatter CTA; the card allows "
            f"{SMEM_LIMIT}")
    return plan
