"""Dense FFN: SwiGLU / GeGLU / plain GELU; port of ``repro/models/mlp.py``.

The products are ``torch.matmul`` (the JAX package leaves them to XLA);
each weight is cast to the activation's dtype at its use, as there.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs import ModelConfig
from repro_torch.launch.mesh import P
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


def specs_mlp(cfg: ModelConfig):
    if cfg.act in ("swiglu", "geglu"):
        return {"w_gate": P("data", "model"), "w_up": P("data", "model"),
                "w_down": P("model", "data")}
    return {"w_up": P("data", "model"), "b_up": P("model"),
            "w_down": P("model", "data"), "b_down": P(None)}


def apply_mlp(p, cfg: ModelConfig, x: torch.Tensor,
              reduce=None) -> torch.Tensor:
    """Under tensor parallelism the weights hold this rank's ``ff``
    columns and ``reduce`` sums the partial outputs over the ranks,
    before ``b_down``."""
    cd = x.dtype
    a = act_fn(cfg.act)
    if cfg.act in ("swiglu", "geglu"):
        g = a(x @ p["w_gate"].to(cd))
        u = x @ p["w_up"].to(cd)
        y = (g * u) @ p["w_down"].to(cd)
        return y if reduce is None else reduce(y)
    h = a(x @ p["w_up"].to(cd) + p["b_up"].to(cd))
    y = h @ p["w_down"].to(cd)
    if reduce is not None:
        y = reduce(y)
    return y + p["b_down"].to(cd)
