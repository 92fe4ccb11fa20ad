"""The port's production grids and the dry pass's shape-only ``DistCtx``
(the port of ``repro/launch/mesh.py``).

The reference lays its cells out on TPU meshes of (16, 16) = 256 chips
(data, model) and (2, 16, 16) = 512 (pod, data, model). The port's grids
are cards: one card (1 x 1, the single-device path, no ``DistCtx``) and
four cards of one host, as dp 2 x bank 2 (the production four-card grid)
or 1 x 4 banks. A grid is a ``Grid``; nothing here touches a device or a
process group, so importing the module does no work.

``DryDistCtx`` is a ``DistCtx`` with no process group: rank 0 of a grid,
on ``meta`` tensors. Its collectives return the shapes the real ones
return (an all-reduce its input's, an all-gather the pieces concatenated)
and report their operand bytes to the cost counters in force
(``launch/roofline.charge_collective``), so a dry pass of a sharded step
needs no ranks. The real ``DistCtx`` is unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.embedding import DistCtx


class Grid(NamedTuple):
    """A data x model (dp x bank) grid of cards."""
    data: int
    model: int
    name: str

    @property
    def axis_names(self) -> tuple[str, ...]:
        return ("dp", "bank")

    @property
    def size(self) -> int:
        return self.data * self.model


def make_production_grid(*, multi_card: bool = False) -> Grid:
    """One card (1 x 1), or four cards as dp 2 x bank 2."""
    return Grid(2, 2, "cards_2x2") if multi_card else Grid(1, 1, "card_1x1")


def make_host_grid(shape=(2, 2)) -> Grid:
    """A grid of any (data, model) shape, such as four cards as 1 x 4
    banks, or a reduced grid for the tests."""
    data, model = (int(x) for x in shape)
    if data < 1 or model < 1:
        raise ValueError(f"a grid of {shape}")
    return Grid(data, model, f"cards_{data}x{model}")


def dp_axes_for(grid: Grid) -> tuple[str, ...]:
    """The grid's data-parallel axes: every axis but the bank axis."""
    return tuple(a for a in grid.axis_names if a != "bank")


@dataclasses.dataclass(frozen=True, eq=False)
class DryDistCtx(DistCtx):
    """A shape-only ``DistCtx`` (see the module doc): build it with
    ``dry``. Every size, rank and slice is the real context's; the
    collectives compute nothing and charge their operand bytes."""

    @classmethod
    def dry(cls, grid: Grid, rank: int = 0,
            device: str | torch.device = "meta") -> DryDistCtx:
        if not 0 <= rank < grid.size:
            raise ValueError(f"rank {rank} of a {grid.data} x {grid.model} "
                             f"grid")
        return cls(data=grid.data, model=grid.model, rank=rank,
                   device=torch.device(device), bank_group=None,
                   dp_group=None)

    def _all_reduce(self, x: torch.Tensor, axes, op) -> torch.Tensor:
        from repro_torch.launch.roofline import charge_collective
        _, size = self._group(axes)
        y = x.clone().contiguous()
        if size > 1:
            charge_collective("all-reduce", y.numel() * y.element_size())
        return y

    def gather(self, x: torch.Tensor, axes="dp", dim: int = 0
               ) -> torch.Tensor:
        from repro_torch.launch.roofline import charge_collective
        _, size = self._group(axes)
        x = x.contiguous()
        if size == 1:
            return x.clone()
        charge_collective("all-gather", x.numel() * x.element_size())
        return torch.cat([torch.empty_like(x) for _ in range(size)], dim=dim)


def make_dist(grid: Grid) -> DryDistCtx | None:
    """The context of a dry pass on ``grid``: None on one card (the
    single-device path the card runs), a ``DryDistCtx`` otherwise."""
    return None if grid.size == 1 else DryDistCtx.dry(grid)
