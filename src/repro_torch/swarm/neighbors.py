"""Fixed-width neighbour lists via spatial-hash bucket search, port of
``repro/swarm/neighbors.py`` on [R, N, 2] positions.

1. hash every node into a G × G grid of cells;
2. sort node ids by cell id once (stable), so ``searchsorted`` yields each
   cell's contiguous [start, end) slice;
3. every node gathers ``cap`` candidates from each of its 9 surrounding
   cells and keeps the K nearest by squared distance.

``lax.top_k`` puts the lower candidate position first on ties; here a
stable ascending sort on the distance does the same, so the K boundary
matches.  Lists come out sorted by node id with invalid slots last, so
argmin/argmax tie-breaks over K match the dense path's lowest index.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.configs import SwarmConfig
from repro_torch.core.fp import div
from repro_torch.swarm.channel import sq_norm2

MAX_GRID = 256


def comm_range_m(cfg: SwarmConfig) -> float:
    """Distance at which the channel's deterministic pathloss baseline
    crosses ``snr_min_db``, plus a fade margin for stochastic models;
    ``neighbor_range_m`` overrides it."""
    if cfg.neighbor_range_m > 0.0:
        return cfg.neighbor_range_m
    diag = cfg.area_m * math.sqrt(2.0)
    budget = cfg.tx_power_dbm - cfg.noise_dbm - cfg.snr_min_db
    name = cfg.channel_model
    if name == "two_ray":
        r = 10.0 ** ((budget
                      + 20.0 * math.log10(cfg.altitude_m * cfg.altitude_m))
                     / 40.0)
    elif name in ("free_space", "log_normal", "log_normal_corr", "rician",
                  "nakagami"):
        fspl1 = 20.0 * math.log10(cfg.carrier_hz) - 147.55
        n_exp = 2.0 if name == "free_space" else cfg.pathloss_exp
        margin = 0.0
        if name in ("log_normal", "log_normal_corr"):
            margin = 3.0 * cfg.shadowing_sigma_db
        elif name in ("rician", "nakagami"):
            margin = 10.0
        r = 10.0 ** ((budget - fspl1 + margin) / (10.0 * n_exp))
    else:
        r = diag
    return min(r, diag)


def grid_geometry(cfg: SwarmConfig, n: int, k: int) -> Tuple[int, float, int]:
    """(G, cell_m, cell_cap) of the bucket grid for an N-node swarm."""
    r = comm_range_m(cfg)
    density_cell = 0.75 * cfg.area_m * math.sqrt(max(k, 1) / max(n, 1))
    target = max(min(r, density_cell), cfg.area_m / MAX_GRID)
    G = max(int(cfg.area_m / target), 1)
    cell = cfg.area_m / G
    if cfg.neighbor_cell_cap > 0:
        cap = cfg.neighbor_cell_cap
    elif n <= 1024:
        cap = n
    else:
        lam = n / float(G * G)
        cap = max(2 * k, int(math.ceil(4.0 * lam)) + 8)
    return G, cell, min(cap, n)


def neighbor_lists(pos: torch.Tensor, cfg: SwarmConfig, k: int | None = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """pos [R, N, 2] -> (nbr [R, N, K] int32 ascending by id, valid
    [R, N, K] bool); invalid slots carry index 0."""
    R, n, _ = pos.shape
    dev = pos.device
    k = cfg.neighbor_k if k is None else k
    k = max(1, min(k, n - 1)) if n > 1 else 1
    G, cell, cap = grid_geometry(cfg, n, k)
    r = comm_range_m(cfg)

    ix = div(pos[..., 0], cell).to(torch.int32).clamp(0, G - 1)
    iy = div(pos[..., 1], cell).to(torch.int32).clamp(0, G - 1)
    cid = ix * G + iy                                    # [R, N]
    order = torch.argsort(cid, dim=-1, stable=True)
    scid = torch.gather(cid, 1, order).contiguous()
    cells = torch.arange(G * G, dtype=cid.dtype, device=dev).expand(R, -1)
    cells = cells.contiguous()
    starts = torch.searchsorted(scid, cells)
    ends = torch.searchsorted(scid, cells, right=True)

    window = torch.arange(cap, device=dev)
    cand_parts, ok_parts = [], []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            cx, cy = ix + dx, iy + dy
            in_grid = (cx >= 0) & (cx < G) & (cy >= 0) & (cy < G)
            c = (cx.clamp(0, G - 1) * G + cy.clamp(0, G - 1)).long()
            s = torch.gather(starts, 1, c)
            e = torch.gather(ends, 1, c)
            slot = s[..., None] + window                 # [R, N, cap]
            ok_parts.append(in_grid[..., None] & (slot < e[..., None]))
            flat = slot.clamp(0, n - 1).reshape(R, -1)
            cand_parts.append(torch.gather(order, 1, flat).view(R, n, cap))
    cand = torch.cat(cand_parts, dim=-1)                 # [R, N, 9·cap]
    ok = torch.cat(ok_parts, dim=-1)

    pc = torch.gather(pos, 1, cand.reshape(R, -1, 1).expand(-1, -1, 2))
    d = pos[:, :, None, :] - pc.view(R, n, -1, 2)
    d2 = sq_norm2(d)
    ok &= cand != torch.arange(n, device=dev)[:, None]   # never yourself
    ok &= d2 <= float(torch.tensor(r * r, dtype=torch.float32))
    score = torch.where(ok, d2, math.inf)
    d2_sorted, sel = torch.sort(score, dim=-1, stable=True)
    sel = sel[..., :k]
    nbr = torch.gather(cand, -1, sel)
    valid = d2_sorted[..., :k] < math.inf
    # canonical ascending-id order, invalid slots last
    perm = torch.argsort(torch.where(valid, nbr, n), dim=-1, stable=True)
    nbr = torch.gather(nbr, -1, perm)
    valid = torch.gather(valid, -1, perm)
    return torch.where(valid, nbr, 0).to(torch.int32), valid


def mask_neighbors(valid: torch.Tensor, nbr: torch.Tensor,
                   alive: torch.Tensor) -> torch.Tensor:
    """Down nodes have no links in either direction: valid/nbr [R, N, K],
    alive [R, N]."""
    R, n, k = nbr.shape
    alive_nbr = torch.gather(alive, 1, nbr.reshape(R, -1).long()).view(
        R, n, k)
    return valid & alive[..., None] & alive_nbr
