"""Declarative scenario sweeps (DESIGN.md §8.1); port of
``repro/fleet/sweep.py``, with the port's ``SwarmConfig`` and strategy
names, so a port spec and a reference spec of the same grid expand to the
same labels in the same order.

A :class:`SweepSpec` names a scenario grid — config-field axes × offloading
strategies × Monte-Carlo runs — and ``expand()`` unrolls it into concrete
:class:`SweepPoint`\\ s, one per grid cell.  Each point carries a fully
resolved static ``SwarmConfig``, so executing a point is one ``run_sim`` of the
simulator's ``(cfg, n)`` regardless of backend; the Monte-Carlo/seed axis
inside a point is the *batched* axis the executors batch, shard or stream
over (``fleet/executor.py``).

Axes come in two shapes:

  * **field axis** — the axis name is a ``SwarmConfig`` field and each value
    is assigned to it directly: ``{"gamma": (0.01, 0.02)}``;
  * **composite axis** — each value is a ``(label, overrides)`` pair where
    ``overrides`` is a dict of config fields, for grid dimensions that move
    several fields at once: ``{"scenario": (("rwp", {"mobility_model":
    "random_waypoint", "channel_model": "log_normal"}), ...)}``.

Unknown field names fail loudly at expansion time (same philosophy as the
scenario registries: a typo'd sweep dies before it runs).  The grid
expands into per-point configs; only the seed axis is batched.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
from typing import Any, Dict, Mapping, NamedTuple, Sequence, Tuple

from repro_torch.configs import SwarmConfig

_CFG_FIELDS = {f.name for f in dataclasses.fields(SwarmConfig)}
# tuple-typed config fields (exit_points, …) — JSON lists convert back
_CFG_TUPLE_FIELDS = {f.name for f in dataclasses.fields(SwarmConfig)
                     if isinstance(getattr(SwarmConfig(), f.name), tuple)}


def _cfg_from_dict(d: Mapping[str, Any]) -> SwarmConfig:
    return SwarmConfig(**{k: tuple(v) if k in _CFG_TUPLE_FIELDS else v
                          for k, v in d.items()})


class SweepPoint(NamedTuple):
    """One grid cell: a static config + strategy, with its seed axis."""
    label: str                           # "gamma=0.02/strategy=Distributed"
    coords: Tuple[Tuple[str, Any], ...]  # ((axis, value-or-label), ...)
    cfg: SwarmConfig
    strategy: int
    n: int                               # swarm size (= cfg.num_workers)
    num_runs: int                        # Monte-Carlo axis length
    seed: int

    @property
    def values(self) -> Dict[str, Any]:
        return dict(self.coords)


def _strategy_name(s: int) -> str:
    from repro_torch.swarm.simulator import STRATEGY_NAMES
    return STRATEGY_NAMES[s]


def _apply_axis(axis: str, value: Any) -> Tuple[Any, Dict[str, Any]]:
    """Returns (coordinate label/value, config overrides) for one cell."""
    if isinstance(value, tuple) and len(value) == 2 and isinstance(
            value[1], Mapping):
        label, overrides = value
        bad = set(overrides) - _CFG_FIELDS
        if bad:
            raise ValueError(
                f"sweep axis {axis!r} cell {label!r} overrides unknown "
                f"SwarmConfig fields {sorted(bad)}")
        return label, dict(overrides)
    if axis not in _CFG_FIELDS:
        raise ValueError(
            f"sweep axis {axis!r} is not a SwarmConfig field; either use a "
            "known field name or (label, overrides-dict) cell values")
    return value, {axis: value}


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """A scenario grid: axes × strategies × seeds, expanded lazily."""
    name: str
    base: SwarmConfig = SwarmConfig()
    # ordered ((axis, (cell, ...)), ...); see module docstring for cell forms
    axes: Tuple[Tuple[str, Tuple[Any, ...]], ...] = ()
    strategies: Tuple[int, ...] = (4,)   # DISTRIBUTED
    num_runs: int = 16
    seed: int = 0

    @classmethod
    def build(cls, name: str, base: SwarmConfig | None = None, *,
              axes: Mapping[str, Sequence[Any]] | None = None,
              strategies: Sequence[int] = (4,), num_runs: int = 16,
              seed: int = 0) -> "SweepSpec":
        """Normalizing constructor: accepts a mapping/sequences for axes."""
        base = SwarmConfig() if base is None else base
        ax = tuple((k, tuple(v)) for k, v in (axes or {}).items())
        return cls(name=name, base=base, axes=ax,
                   strategies=tuple(int(s) for s in strategies),
                   num_runs=int(num_runs), seed=int(seed))

    def expand(self) -> Tuple[SweepPoint, ...]:
        axis_names = [a for a, _ in self.axes]
        axis_cells = [cells for _, cells in self.axes]
        points = []
        for combo in itertools.product(*axis_cells) if axis_cells else [()]:
            coords, overrides = [], {}
            for axis, cell in zip(axis_names, combo, strict=True):
                coord, ov = _apply_axis(axis, cell)
                coords.append((axis, coord))
                overrides.update(ov)
            cfg = (dataclasses.replace(self.base, **overrides)
                   if overrides else self.base)
            for s in self.strategies:
                label = "/".join([f"{a}={c}" for a, c in coords]
                                 + [f"strategy={_strategy_name(s)}"])
                points.append(SweepPoint(
                    label=label, coords=tuple(coords), cfg=cfg,
                    strategy=int(s), n=cfg.num_workers,
                    num_runs=self.num_runs, seed=self.seed))
        return tuple(points)

    def __len__(self) -> int:
        n = len(self.strategies)
        for _, cells in self.axes:
            n *= len(cells)
        return n

    # ---- cross-process contract (fleet/dispatch.py) ----------------------

    def to_json(self) -> str:
        """Serialize the spec for dispatch workers (other processes/hosts).

        The JSON round-trips exactly: ``from_json(to_json())`` expands to
        the same points with the same digests, which is what lets a remote
        worker claim and compute points for a sweep it never constructed.
        """
        return json.dumps({
            "name": self.name,
            "base": dataclasses.asdict(self.base),
            "axes": [[a, list(cells)] for a, cells in self.axes],
            "strategies": list(self.strategies),
            "num_runs": self.num_runs,
            "seed": self.seed,
        }, sort_keys=True)

    @classmethod
    def from_json(cls, blob: str) -> "SweepSpec":
        doc = json.loads(blob)

        def cell(c):
            # composite cells serialize as [label, {overrides}]; everything
            # else is a plain config value (lists were tuples)
            if (isinstance(c, list) and len(c) == 2
                    and isinstance(c[1], dict)):
                # tuple-typed override values (exit_points, …) came through
                # JSON as lists; restore them or the rebuilt frozen config
                # is unhashable
                return (c[0], {k: tuple(v) if k in _CFG_TUPLE_FIELDS
                               and isinstance(v, list) else v
                               for k, v in c[1].items()})
            return tuple(c) if isinstance(c, list) else c

        return cls(
            name=doc["name"], base=_cfg_from_dict(doc["base"]),
            axes=tuple((a, tuple(cell(c) for c in cells))
                       for a, cells in doc["axes"]),
            strategies=tuple(int(s) for s in doc["strategies"]),
            num_runs=int(doc["num_runs"]), seed=int(doc["seed"]))
