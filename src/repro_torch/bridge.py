"""State and weights carried between the JAX reference and the port,
through numpy.

``state_from_numpy`` takes the reference's ``init_state`` pytree (or a
state after some epochs) as numpy arrays and returns the port's state: the
same keys, dtypes kept (bool, int32, float32), a leading run axis added
where the reference state has none.  ``state_to_numpy`` goes the other
way.  A test can so take the reference's state after e epochs, step one
epoch in both packages with the same key, and compare: that is how a
divergence is located.

``params_from_numpy`` takes the reference's parameter pytree
(``init_lm``, ``init_ssm_lm``, ``init_hybrid`` or ``init_encdec``) as
numpy and returns the port's module on those weights (an ``LM``, or an
``EncDec`` for the encdec family); ``params_to_numpy`` goes back.  Every
leaf keeps its JAX layout (``wq [d,Hq,hd]``, ``wo [Hq,hd,d]``, ``w_gate
[d,ff]``, ``A_log [d_in,N]``, ...); the only change is that the stacked
leaves are split into one dict per layer: ``layers [L, ...]`` of the
dense and ssm families, encdec's ``enc_layers [E, ...]`` and
``dec_layers [L, ...]``, and the hybrid family's ``super [n_super, ...]``
of sublayers ``s{j}_{kind}`` and ``tail [tail, ...]``, which become layers
3i + j and 3·n_super + t of one flat list.  Both are exact copies.

``caches_from_numpy`` and ``caches_to_numpy`` carry the ssm, hybrid and
encdec families' decode caches: the reference's stacked ``(conv [L,...],
h [L,...])`` (ssm) or ``{"super": {name: pair}, "tail": pair}`` (hybrid)
against the port's list of one pair per layer, and encdec's four-tuple
``(self K, self V, cross K, cross V)`` of ``[L, B, S|F, Hkv, hd]``, kept
stacked as the port keeps it.

Training: ``tree_from_named`` and ``named_from_tree`` map the port's
parameter names (``layers.3.attn.wq``, ``dec_layers.3.self_attn.wq``)
onto the reference's stacked tree paths (``layers/attn/wq[3]``, the
hybrid's ``super``/``tail``, encdec's ``enc_layers``/``dec_layers``) and
back, for any leaves shaped like the parameters: ``grads_to_numpy`` takes
the port's gradients to the reference's grad tree, ``opt_from_numpy`` the
reference's ``OptState`` (step, m, v) to the port's, and
``train_state_from_numpy`` / ``train_state_to_numpy`` a whole
``TrainState`` (the reference's ``{"params", "opt"}`` as numpy, the
port's with trainable parameters).

The converters that build tensors (``state_from_numpy``,
``params_from_numpy``, ``caches_from_numpy``, ``opt_from_numpy``,
``train_state_from_numpy``) put them on the card unless the caller passes
``device="cpu"``, as the port's other entry points do.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.launch.step import TrainState, trainable
from repro_torch.models.common import dt, param_dict
from repro_torch.models.encdec import EncDec
from repro_torch.models.hybrid import _pattern
from repro_torch.models.transformer import LM
from repro_torch.optim import OptState

_DTYPES = {np.dtype(np.bool_): torch.bool, np.dtype(np.int32): torch.int32,
           np.dtype(np.float32): torch.float32,
           np.dtype(np.uint32): torch.uint32}


def _to_torch(a, device, batched: bool) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {a.dtype} in a swarm state")
    if not batched:
        a = a[None]
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def state_from_numpy(state: Dict, device=None) -> Dict:
    """numpy state dict (nested dicts allowed) -> torch state with a run
    axis.  A state whose ``q_active`` is [N, Q] has no run axis; one whose
    ``q_active`` is [R, N, Q] has."""
    device = resolve_device(device)
    batched = np.ndim(state["q_active"]) == 3

    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return _to_torch(v, device, batched)

    return {k: conv(v) for k, v in state.items()}


def state_to_numpy(state: Dict) -> Dict:
    """torch state -> nested dict of numpy arrays (run axis kept)."""
    return {k: state_to_numpy(v) if isinstance(v, dict)
            else v.detach().cpu().numpy() for k, v in state.items()}


def key_from_numpy(key) -> torch.Tensor:
    """A raw jax key (uint32 [..., 2], as numpy) -> the port's key."""
    return torch.from_numpy(np.array(key, dtype=np.uint32))


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype != np.float32:
        raise TypeError(f"unsupported dtype {a.dtype} in LM parameters")
    return torch.from_numpy(np.array(a)).to(device)


def _leaves(tree: Dict, device) -> Dict:
    return {k: _leaves(v, device) if isinstance(v, dict) else _leaf(v, device)
            for k, v in tree.items()}


def _layer(stack: Dict, i: int) -> nn.ModuleDict:
    """Layer ``i`` of a stacked {name: {leaf: [n, ...]}} tree."""
    return nn.ModuleDict({name: param_dict(**{k: v[i] for k, v in sub.items()})
                          for name, sub in stack.items()})


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _stack(layers) -> Dict:
    """{name: {leaf: [n, ...]}} of a list of same-shaped layers."""
    return {name: {k: np.stack([_np(layer[name][k]) for layer in layers])
                   for k in layers[0][name].keys()}
            for name in layers[0].keys()}


def _stacks(cfg) -> Dict[str, int]:
    """The reference's stacked layer trees of ``cfg``'s family and their
    depths (the hybrid's ``super``/``tail`` are handled apart)."""
    if cfg.family == "encdec":
        return {"enc_layers": cfg.encdec.encoder_layers,
                "dec_layers": cfg.num_layers}
    return {"layers": cfg.num_layers}


def params_from_numpy(tree: Dict, cfg, device=None):
    """The reference's parameter pytree (numpy float32 leaves) -> the
    port's ``LM`` module (``EncDec`` for encdec), weights copied
    exactly."""
    device = resolve_device(device)
    t = _leaves(tree, device)
    if cfg.family == "encdec":
        enc, dec = ([_layer(t[k], i) for i in range(n)]
                    for k, n in _stacks(cfg).items())
        return EncDec(cfg, t["embed"], t["enc_pos"], t["dec_pos"], enc, dec,
                      param_dict(**t["enc_norm"]),
                      param_dict(**t["dec_norm"]))
    if cfg.family == "hybrid":
        pat, n_super, tail, _ = _pattern(cfg)
        layers = [_layer(t["super"][f"s{j}_{kind}"], i)
                  for i in range(n_super) for j, kind in enumerate(pat)]
        layers += [_layer(t["tail"], i) for i in range(tail)]
    else:
        layers = [_layer(t["layers"], i) for i in range(cfg.num_layers)]
    return LM(cfg, t["embed"], layers, param_dict(**t["final_norm"]),
              t.get("lm_head"))


def tree_from_named(named: Dict[str, np.ndarray], cfg) -> Dict:
    """{port parameter name: array} -> the reference's pytree layout, the
    layers' leaves stacked as the reference stacks them."""
    tree: Dict = {}
    stacks = {k: [{} for _ in range(n)] for k, n in _stacks(cfg).items()}
    for name, a in named.items():
        head, *rest = name.split(".")
        if head in stacks:
            i, sub, leaf = rest
            stacks[head][int(i)].setdefault(sub, {})[leaf] = a
        elif rest:
            tree.setdefault(head, {})[rest[0]] = a
        else:
            tree[head] = a
    if cfg.family == "encdec":
        tree.update({k: _stack(v) for k, v in stacks.items()})
        return tree
    layers = stacks["layers"]
    if cfg.family == "hybrid":
        pat, n_super, tail, _ = _pattern(cfg)
        P = len(pat)
        tree["super"] = {f"s{j}_{kind}": _stack([layers[P * i + j]
                                                 for i in range(n_super)])
                         for j, kind in enumerate(pat)}
        if tail:
            tree["tail"] = _stack(layers[P * n_super:])
    else:
        tree["layers"] = _stack(layers)
    return tree


def named_from_tree(tree: Dict, cfg, device=None) -> Dict[str, torch.Tensor]:
    """The reference's pytree of float32 leaves (params, grads, m or v) ->
    {port parameter name: tensor}."""
    lm = params_from_numpy(tree, cfg, device=device)
    return {n: p.detach() for n, p in lm.named_parameters()}


def params_to_numpy(lm) -> Dict:
    """The port's ``LM`` module -> the reference's pytree layout, numpy,
    with the layers' leaves stacked as the reference stacks them."""
    return tree_from_named({n: _np(p) for n, p in lm.named_parameters()},
                           lm.cfg)


def grads_to_numpy(grads: Dict[str, torch.Tensor], cfg) -> Dict:
    """The port's gradients by parameter name -> the reference's grad
    tree (numpy float32)."""
    return tree_from_named({n: _np(g.float()) for n, g in grads.items()},
                           cfg)


def opt_from_numpy(opt, cfg, device=None):
    """The reference's ``OptState`` (``step``, ``m``, ``v``; numpy leaves)
    -> the port's, its step on the host."""
    return OptState(torch.tensor(int(np.asarray(opt.step)),
                                 dtype=torch.int32),
                    named_from_tree(opt.m, cfg, device),
                    named_from_tree(opt.v, cfg, device))


def train_state_from_numpy(state, cfg, device=None):
    """The reference's ``TrainState`` (``params``, ``opt``; numpy leaves)
    -> the port's, its parameters trainable."""
    return TrainState(trainable(params_from_numpy(state.params, cfg,
                                                  device=device)),
                      opt_from_numpy(state.opt, cfg, device=device))


def train_state_to_numpy(state) -> Dict:
    """The port's ``TrainState`` -> ``{"params", "opt": {"step", "m",
    "v"}}`` in the reference's layout, numpy."""
    cfg = state.params.cfg
    return {"params": params_to_numpy(state.params),
            "opt": {"step": np.int32(int(state.opt.step)),
                    "m": grads_to_numpy(state.opt.m, cfg),
                    "v": grads_to_numpy(state.opt.v, cfg)}}


# ---------------------------------------------------------------------------
# decode caches of the ssm and hybrid families
# ---------------------------------------------------------------------------


def _cache_leaf(a, dtype, device) -> torch.Tensor:
    """A float32 or bfloat16 numpy array -> a tensor of ``dtype``; exact,
    since both widen to float32 exactly."""
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(
        device=device, dtype=dtype)


def _cache_dtypes(cfg, kind: str):
    """(dtype of the first, of the second tensor of a layer's pair)."""
    cd = dt(cfg.compute_dtype)
    return (cd, cd) if kind == "attn" else (cd, torch.float32)


def caches_from_numpy(tree, cfg, device=None) -> List:
    """The reference's ssm, hybrid or encdec decode caches (numpy, float32
    or bfloat16) -> the port's: a list of one pair per layer, or encdec's
    four stacked tensors in the compute dtype."""
    device = resolve_device(device)
    if cfg.family == "encdec":
        cd = dt(cfg.compute_dtype)
        return tuple(_cache_leaf(x, cd, device) for x in tree)
    if cfg.family == "ssm":
        conv, h = tree
        dts = _cache_dtypes(cfg, "ssm")
        return [(_cache_leaf(conv[i], dts[0], device),
                 _cache_leaf(h[i], dts[1], device))
                for i in range(cfg.num_layers)]
    if cfg.family != "hybrid":
        raise ValueError(f"no cache bridge for the {cfg.family!r} family")
    pat, n_super, tail, tail_kind = _pattern(cfg)
    out = []
    for i in range(n_super):
        for j, kind in enumerate(pat):
            pair = tree["super"][f"s{j}_{kind}"]
            dts = _cache_dtypes(cfg, kind)
            out.append(tuple(_cache_leaf(x[i], d, device)
                             for x, d in zip(pair, dts, strict=True)))
    for i in range(tail):
        dts = _cache_dtypes(cfg, tail_kind)
        out.append(tuple(_cache_leaf(x[i], d, device)
                         for x, d in zip(tree["tail"], dts, strict=True)))
    return out


def caches_to_numpy(caches: List, cfg):
    """The port's ssm, hybrid or encdec caches -> the reference's layout,
    numpy float32."""
    def f32(x):
        return x.detach().float().cpu().numpy()

    if cfg.family == "encdec":
        return tuple(f32(x) for x in caches)

    def stack(pairs):
        return tuple(np.stack([f32(p[k]) for p in pairs]) for k in (0, 1))

    if cfg.family == "ssm":
        return stack(caches)
    if cfg.family != "hybrid":
        raise ValueError(f"no cache bridge for the {cfg.family!r} family")
    pat, n_super, tail, _ = _pattern(cfg)
    P = len(pat)
    return {"super": {f"s{j}_{kind}": stack([caches[P * i + j]
                                             for i in range(n_super)])
                      for j, kind in enumerate(pat)},
            "tail": stack(caches[P * n_super:]) if tail else None}
