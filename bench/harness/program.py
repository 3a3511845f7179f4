"""The system under test, reached through its own entry points: the
port's configuration, its ``LM`` holding the benchmark's weights, the
training step of ``launch.step.make_train_step`` and the split-serve engine
over a ``plan_stages`` plan.  The only module of the harness that imports
the program."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs import ModelConfig, get_config
from repro_torch.kernels import ops
from repro_torch.launch.step import TrainState, make_train_step, trainable
from repro_torch.models import build_model
from repro_torch.models.common import param_dict
from repro_torch.models.transformer import LM
from repro_torch.optim import OptConfig, init_opt
from repro_torch.splitcompute import SplitServeEngine, plan_stages
from repro_torch.trace import schema


def port_config(model: Dict) -> ModelConfig:
    """The port's configuration of ``model`` (a configuration file's
    object): the port's architecture with every size the file states."""
    run = model["run_as"]
    cfg = get_config(model["port_arch"])
    kw = dict(num_layers=model["num_hidden_layers"],
              d_model=model["hidden_size"],
              num_heads=model["num_attention_heads"],
              num_kv_heads=model["num_key_value_heads"],
              head_dim=model["head_dim"], vocab_size=model["vocab_size"],
              d_ff=model["intermediate_size"],
              rope_theta=float(model["rope_theta"]),
              tie_embeddings=bool(model["tie_word_embeddings"]),
              qk_norm=bool(run.get("qk_norm", False)),
              param_dtype=run["param_dtype"],
              compute_dtype=run["compute_dtype"],
              cast_weights_bf16=bool(run["cast_weights_bf16"]),
              remat_policy=run["remat_policy"])
    if model.get("num_local_experts"):
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=model["num_local_experts"],
            experts_per_token=model["num_experts_per_tok"],
            d_ff_expert=model["intermediate_size"],
            capacity_factor=run["capacity_factor"],
            router_norm_topk=bool(run["router_norm_topk"]),
            router_aux_loss=float(run["router_aux_loss"]))
    return dataclasses.replace(cfg, **kw)


def port_lm(cfg: ModelConfig, tree: Dict) -> LM:
    """The port's ``LM`` over the benchmark's weights: each layer's leaves
    are views of the stacked draws (no copy)."""
    layers = [nn.ModuleDict({sub: param_dict(**{k: v[i]
                                                for k, v in leaves.items()})
                             for sub, leaves in tree["layers"].items()})
              for i in range(cfg.num_layers)]
    return LM(cfg, tree["embed"], layers, param_dict(**tree["final_norm"]))


def opt_config(mix: Dict) -> OptConfig:
    return OptConfig(**mix["optimizer"])


def train_state(cfg: ModelConfig, tree: Dict) -> TrainState:
    params = trainable(port_lm(cfg, tree))
    return TrainState(params, init_opt(params))


def train_step(cfg: ModelConfig, mix: Dict):
    return make_train_step(build_model(cfg), opt_config(mix))


def first_moment(state: TrainState) -> Dict[str, torch.Tensor]:
    return state.opt.m


def named_params(state: TrainState) -> Dict[str, torch.Tensor]:
    return dict(state.params.named_parameters())


def executors(spec: Dict) -> np.ndarray:
    """Executor capabilities as ``launch.serve.serve`` draws them."""
    return np.maximum(np.random.default_rng(spec["seed"]).normal(
        spec["mean"], spec["std"], spec["count"]), spec["floor"])


def serve_engine(cfg: ModelConfig, tree: Dict, mix: Dict,
                 params: LM = None) -> SplitServeEngine:
    plan = plan_stages(cfg, executors(mix["executors"]))
    return SplitServeEngine(cfg, params if params is not None
                            else port_lm(cfg, tree), plan,
                            tau_med=mix["tau_med"], tau_high=mix["tau_high"],
                            alpha=mix["alpha"],
                            max_results=mix["max_results"])


def served_depths(cfg: ModelConfig, mix: Dict) -> List[int]:
    """The layer counts at which the engine can finish a request under
    ``mix``: every stage boundary from the stage of its earliest exit on
    (``SplitServeEngine._exit_stage``), or the full depth alone where the
    mix's thresholds (1e30) keep the exit off."""
    bounds = plan_stages(cfg, executors(mix["executors"])).boundaries
    L = cfg.num_layers
    if mix["tau_med"] >= 1e30:
        return [L]
    earliest = max(min(cfg.exit_layers_), 1)
    return sorted({int(b) for b in bounds[1:] if b >= earliest} | {L})


_COLS = {f: schema.FIELDS.index(f) for f in ("seq", "exit_label", "layers")}


def completions(engine: SplitServeEngine) -> Dict[int, Tuple[int, int]]:
    """{request id: (exit label, layers run)} from the engine's records."""
    rec = engine.stats.records
    return {int(r[_COLS["seq"]]): (int(r[_COLS["exit_label"]]),
                                   int(r[_COLS["layers"]])) for r in rec}


class FlashShapes:
    """Records the shape of every flash-attention forward call while
    active: ``(B, S, Hq, Hkv, hd, causal)``."""

    def __init__(self):
        self.calls: List[Tuple[int, ...]] = []
        self._orig = None

    def __enter__(self):
        self._orig = orig = ops.flash_attention

        def spy(q, k, v, *args, **kwargs):
            causal = kwargs.get("causal", args[0] if args else True)
            self.calls.append((q.shape[0], q.shape[1], q.shape[2],
                               k.shape[2], q.shape[3], bool(causal)))
            return orig(q, k, v, *args, **kwargs)

        ops.flash_attention = spy
        return self

    def __exit__(self, *exc):
        ops.flash_attention = self._orig
