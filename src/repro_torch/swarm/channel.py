"""Communication models (paper §3.2), port of ``repro/swarm/channel.py``:
pathloss -> SNR (Eq. 4) -> Shannon capacity (Eq. 3) -> one-hop adjacency
(Eq. 9), on [R, N, N] matrices (dense) or gathered [R, N, K] edges
(sparse).

Dense pathloss models have the signature ``(keys [R, 2], dist, cfg) -> dB``
and per-edge models ``(keys, dist, src, dst, cfg) -> dB``; deterministic
models ignore the keys.  All six of the reference's models are here, dense
and per edge, but ``log_normal_corr`` (a Cholesky field over the nodes),
which has no per-edge form in the reference either.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import rng
from repro_torch.configs import SwarmConfig
from repro_torch.core.fp import div, fma


def sq_norm2(d: torch.Tensor) -> torch.Tensor:
    """sum(d**2, -1) over a last axis of 2, in XLA's order: the first
    square rounded, the second fused into the add."""
    return fma(d[..., 1], d[..., 1], d[..., 0] * d[..., 0])


def pairwise_distance(pos: torch.Tensor) -> torch.Tensor:
    """pos [R, N, 2] metres -> [R, N, N] distances (diag = 0)."""
    d = pos[..., :, None, :] - pos[..., None, :, :]
    return torch.sqrt(sq_norm2(d) + 1e-9)


# jnp.log10(x) is log(x)·f32(1/ln 10) and jnp.log2(x) is log(x)/f32(ln 2),
# which XLA turns into log(x)·f32(1/ln 2); a constant factor in front folds
# into that multiplier (one rounding of the product of the constants), and
# a following add fuses into a multiply-add
_LOG10_E = np.float32(0.4342944819032518)
_LOG2_E = np.float32(1.0) / np.float32(np.log(2.0))


def _scaled_log(x, log_e, a, b):
    """a·log_base(x) + b as the reference's compiled code evaluates it."""
    return fma(torch.log(x), float(np.float32(a) * log_e), b)


def _log10_const(x: float) -> np.float32:
    """log10 of a float32 constant, folded in float32 (the reference pins
    its constants to f32)."""
    return np.log(np.float32(x)) * _LOG10_E


# ---------------------------------------------------------------------------
# pathloss models
# ---------------------------------------------------------------------------


def two_ray_pathloss_db(dist_m, h_tx: float, h_rx: float):
    """Two-ray ground reflection, far field:
    PL(dB) = 40 log10(d) - 20 log10(h_t·h_r); the height term is a float32
    constant, as the reference pins it."""
    d = torch.clamp_min(dist_m, 1.0)
    c = np.float32(20.0) * _log10_const(h_tx * h_rx)
    return _scaled_log(d, _LOG10_E, 40.0, -float(c))


def two_ray(keys, dist_m, cfg: SwarmConfig):
    return two_ray_pathloss_db(dist_m, cfg.altitude_m, cfg.altitude_m)


def _fspl_1m_db(cfg: SwarmConfig) -> float:
    """Friis free-space loss at 1 m: 20 log10(f) - 147.55, in float32."""
    return float(np.float32(20.0) * _log10_const(cfg.carrier_hz)
                 - np.float32(147.55))


def free_space(keys, dist_m, cfg: SwarmConfig):
    d = torch.clamp_min(dist_m, 1.0)
    return _scaled_log(d, _LOG10_E, 20.0, _fspl_1m_db(cfg))


def _log_distance_db(dist_m, cfg: SwarmConfig):
    d = torch.clamp_min(dist_m, 1.0)
    return _scaled_log(d, _LOG10_E, 10.0 * cfg.pathloss_exp,
                       _fspl_1m_db(cfg))


def _mirror_gain(g: torch.Tensor) -> torch.Tensor:
    u = torch.triu(g, 1)
    n = g.shape[-1]
    return u + u.transpose(-1, -2) + torch.eye(n, dtype=g.dtype,
                                               device=g.device)


def log_normal(keys, dist_m, cfg: SwarmConfig):
    """Log-distance pathloss with symmetric log-normal shadowing."""
    base = _log_distance_db(dist_m, cfg)
    n = dist_m.shape[-1]
    z = rng.normal(keys, (n, n)) * cfg.shadowing_sigma_db
    upper = torch.triu(z, 1)
    return base + upper + upper.transpose(-1, -2)


def log_normal_corr(keys, dist_m, cfg: SwarmConfig):
    """Log-distance pathloss with spatially correlated log-normal shadowing
    (Gudmundson): a node field z ~ N(0, Σ), Σ_ik = exp(-d_ik /
    ``shadow_corr_m``), drawn through the Cholesky factor of the jittered
    covariance; the link value σ (z_i + z_j) / √(2 (1 + ρ_ij)) keeps the
    marginal N(0, σ²), is symmetric, and is zero on the diagonal.

    jax's Cholesky returns NaN for a matrix that is not positive definite;
    torch's raises (and on CUDA waits on the host), so the factor comes
    from ``cholesky_ex`` and a failed run's factor is set to NaN."""
    base = _log_distance_db(dist_m, cfg)
    n = dist_m.shape[-1]
    eye = torch.eye(n, dtype=dist_m.dtype, device=dist_m.device)
    rho = torch.exp(div(-dist_m, max(cfg.shadow_corr_m, 1e-6)))
    chol, info = torch.linalg.cholesky_ex(rho + 1e-4 * eye,
                                          check_errors=False)
    chol = torch.where((info != 0)[..., None, None], math.nan, chol)
    z = (chol @ rng.normal(keys, (n,))[..., None])[..., 0]
    x = (z[..., :, None] + z[..., None, :]) / torch.sqrt(2.0 * (1.0 + rho))
    return base + cfg.shadowing_sigma_db * x * (1.0 - eye)


def _fading_db(base, g):
    """base - 10·log10(max(g, 1e-12)) for a fading power gain g."""
    return _scaled_log(torch.clamp_min(g, 1e-12), _LOG10_E, -10.0, base)


def _rician_gain(zx, zy, cfg: SwarmConfig):
    K = 10.0 ** (cfg.rician_k_db / 10.0)
    s = math.sqrt(1.0 / (2.0 * (K + 1.0)))
    x = fma(s, zx, math.sqrt(K / (K + 1.0)))
    y = s * zy
    return fma(x, x, y * y)


def rician(keys, dist_m, cfg: SwarmConfig):
    """Log-distance pathloss under unit-mean Rician fading."""
    base = _log_distance_db(dist_m, cfg)
    n = dist_m.shape[-1]
    k = rng.split(keys)
    g = _mirror_gain(_rician_gain(rng.normal(k[..., 0, :], (n, n)),
                                  rng.normal(k[..., 1, :], (n, n)), cfg))
    return _fading_db(base, g)


def nakagami(keys, dist_m, cfg: SwarmConfig):
    """Log-distance pathloss under Nakagami-m fading: the power gain is
    Gamma(m, 1/m) (unit mean), symmetric per link."""
    n = dist_m.shape[-1]
    g = div(rng.gamma(keys, cfg.nakagami_m, (n, n)), cfg.nakagami_m)
    return _fading_db(_log_distance_db(dist_m, cfg), _mirror_gain(g))


# ---------------------------------------------------------------------------
# per-edge pathloss (sparse neighbour-list path)
# ---------------------------------------------------------------------------


def _edge_keys(keys, src, dst):
    """One key per edge, symmetric in (src, dst): the epoch key folded with
    the min id, then with the max id.  keys [R, 2], src/dst [R, N, K] ->
    [R, N·K, 2]."""
    R = keys.shape[0]
    lo = torch.minimum(src, dst).reshape(R, -1)
    hi = torch.maximum(src, dst).reshape(R, -1)
    k = rng.fold_in_each(keys[:, None, :].expand(R, lo.shape[1], 2), lo)
    return rng.fold_in_each(k, hi)


def _edge_normal(keys, src, dst, draws: int = 1):
    """Per-edge standard normals: [R, N, K] (draws=1) or [R, N, K, draws]."""
    z = rng.normal(_edge_keys(keys, src, dst), (draws,)).view(*src.shape,
                                                             draws)
    return z[..., 0] if draws == 1 else z


def _edge_gamma(keys, src, dst, m: float):
    """Per-edge Gamma(m, 1/m) (unit mean), [R, N, K]."""
    g = rng.gamma(_edge_keys(keys, src, dst), m, ())
    return div(g.view(src.shape), m)


def two_ray_edges(keys, dist_m, src, dst, cfg: SwarmConfig):
    return two_ray_pathloss_db(dist_m, cfg.altitude_m, cfg.altitude_m)


def free_space_edges(keys, dist_m, src, dst, cfg: SwarmConfig):
    return free_space(keys, dist_m, cfg)


def log_normal_edges(keys, dist_m, src, dst, cfg: SwarmConfig):
    base = _log_distance_db(dist_m, cfg)
    return base + _edge_normal(keys, src, dst) * cfg.shadowing_sigma_db


def rician_edges(keys, dist_m, src, dst, cfg: SwarmConfig):
    base = _log_distance_db(dist_m, cfg)
    z = _edge_normal(keys, src, dst, draws=2)
    return _fading_db(base, _rician_gain(z[..., 0], z[..., 1], cfg))


def nakagami_edges(keys, dist_m, src, dst, cfg: SwarmConfig):
    return _fading_db(_log_distance_db(dist_m, cfg),
                      _edge_gamma(keys, src, dst, cfg.nakagami_m))


# ---------------------------------------------------------------------------
# SNR / capacity / adjacency
# ---------------------------------------------------------------------------


def snr_from_pathloss_db(pl_db, cfg: SwarmConfig):
    """Eq. 4: SNR_ij = P_i - L(i,j) - N0 (dB/dBm), in the reference's
    order of operations."""
    return (cfg.tx_power_dbm - pl_db) - cfg.noise_dbm


def snr_db(dist_m, cfg: SwarmConfig):
    """Eq. 4 under the default two-ray model."""
    return snr_from_pathloss_db(two_ray(None, dist_m, cfg), cfg)


def capacity_bps(snr, cfg: SwarmConfig):
    """Eq. 3: C = B log2(1 + 10^(SNR/10))."""
    p = torch.pow(10.0, div(snr, 10.0))
    return torch.log(1.0 + p) * float(np.float32(cfg.bandwidth_hz) * _LOG2_E)


def link_state(pos, cfg: SwarmConfig, key=None, pathloss_fn=None):
    """(adj [R, N, N] bool, capacity [R, N, N] bit/s) at positions
    [R, N, 2]; capacity is 1.0 off-link so divisions stay safe."""
    if pathloss_fn is None:
        pathloss_fn = two_ray
    dist = pairwise_distance(pos)
    snr = snr_from_pathloss_db(pathloss_fn(key, dist, cfg), cfg)
    n = pos.shape[-2]
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    adj = (snr >= cfg.snr_min_db) & ~eye
    cap = torch.where(adj, capacity_bps(snr, cfg), 1.0)
    return adj, cap


def _edge_distance(pos, src, dst):
    """Distances of gathered (src, dst) pairs, [R, N, K]; same arithmetic as
    ``pairwise_distance`` so shared pairs are bit-identical."""
    R = pos.shape[0]

    def take(idx):
        flat = idx.reshape(R, -1, 1).long().expand(-1, -1, 2)
        # oob: invalid slots of nbr carry node 0, a real node; their
        # distances are masked by `valid` downstream (J003)
        return torch.gather(pos, 1, flat).view(*idx.shape, 2)

    return torch.sqrt(sq_norm2(take(src) - take(dst)) + 1e-9)


def link_state_sparse(pos, nbr, valid, cfg: SwarmConfig, key=None,
                      pathloss_fn=None):
    """Neighbour-list twin of ``link_state`` on [R, N, K] edges."""
    if pathloss_fn is None:
        pathloss_fn = two_ray_edges
    R, n, k = nbr.shape
    src = torch.arange(n, dtype=torch.int32,
                       device=pos.device)[None, :, None].expand(R, n, k)
    dist = _edge_distance(pos, src, nbr)
    snr = snr_from_pathloss_db(pathloss_fn(key, dist, src, nbr, cfg), cfg)
    adj = valid & (snr >= cfg.snr_min_db)
    cap = torch.where(adj, capacity_bps(snr, cfg), 1.0)
    return adj, cap


def edge_rate(pos, dst, cfg: SwarmConfig, key=None, pathloss_fn=None):
    """Per-node link rate toward ``dst`` [R, N]: the sparse replacement for
    the dense ``cap[rows, tx_dst]`` lookup (1.0 where below threshold or
    pointing at self)."""
    if pathloss_fn is None:
        pathloss_fn = two_ray_edges
    R, n = dst.shape
    rows = torch.arange(n, dtype=torch.int32, device=pos.device).expand(R, n)
    dist = _edge_distance(pos, rows, dst)[..., None]
    snr = snr_from_pathloss_db(
        pathloss_fn(key, dist, rows[..., None], dst[..., None], cfg),
        cfg)[..., 0]
    ok = (snr >= cfg.snr_min_db) & (dst != rows)
    return torch.where(ok, capacity_bps(snr, cfg), 1.0)
