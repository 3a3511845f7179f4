"""Dense FFN: SwiGLU / GeGLU / plain GELU; port of ``repro/models/mlp.py``.

The products are ``torch.matmul`` (the JAX package leaves them to XLA);
each weight is cast to the activation's dtype at its use, as there.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs import ModelConfig
from repro_torch.models.common import act_fn, dense_init, param_dict


def init_mlp(gen: torch.Generator, cfg: ModelConfig, dtype,
             device) -> nn.ParameterDict:
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.act in ("swiglu", "geglu"):
        return param_dict(w_gate=dense_init(gen, (d, ff), d, dtype, device),
                      w_up=dense_init(gen, (d, ff), d, dtype, device),
                      w_down=dense_init(gen, (ff, d), ff, dtype, device))
    return param_dict(w_up=dense_init(gen, (d, ff), d, dtype, device),
                  b_up=torch.zeros((ff,), dtype=dtype, device=device),
                  w_down=dense_init(gen, (ff, d), ff, dtype, device),
                  b_down=torch.zeros((d,), dtype=dtype, device=device))


def apply_mlp(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    cd = x.dtype
    a = act_fn(cfg.act)
    if cfg.act in ("swiglu", "geglu"):
        g = a(x @ p["w_gate"].to(cd))
        u = x @ p["w_up"].to(cd)
        return (g * u) @ p["w_down"].to(cd)
    h = a(x @ p["w_up"].to(cd) + p["b_up"].to(cd))
    return h @ p["w_down"].to(cd) + p["b_down"].to(cd)
