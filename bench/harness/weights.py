"""Weights and token batches drawn from ``--seed``, the same for the
program and the reference.

The weights are a tree of stacked leaves in the layout of the reference
package's parameter pytree: ``embed [V, d]``, ``layers.<sub>.<leaf>
[L, ...]`` and ``final_norm.scale [d]``.  Each stacked leaf is one draw on
the device from a generator of its own, seeded from ``(seed, leaf)``, so
any leaf can be drawn again alone (the training check draws the initial
weights again after the program has updated its own in place).  The
draws are float32, the type the configurations keep their parameters in.

Token batches: a training step's ``[B, S + 1]`` ids (inputs and labels
shifted by one) and a serve request's ``[B, S]`` ids, each from a
generator seeded from ``(seed, stream, index)``.

Plain torch; imports nothing of the program.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import torch

Tree = Dict[str, object]


def derive(seed: int, *parts) -> int:
    """A 63-bit generator seed from a run's seed and a stream's name."""
    h = hashlib.sha256(repr((int(seed), *parts)).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def leaf_specs(model: Dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(dotted name, shape, std) of every stacked leaf; std 0 means ones.
    ``model`` is a configuration file's object (Hugging Face key names)."""
    L, d = model["num_hidden_layers"], model["hidden_size"]
    Hq, Hkv = model["num_attention_heads"], model["num_key_value_heads"]
    hd, V = model["head_dim"], model["vocab_size"]
    ff = model["intermediate_size"]
    specs = [("embed", (V, d), 0.02),
             ("layers.ln1.scale", (L, d), 0.0),
             ("layers.attn.wq", (L, d, Hq, hd), 1 / math.sqrt(d)),
             ("layers.attn.wk", (L, d, Hkv, hd), 1 / math.sqrt(d)),
             ("layers.attn.wv", (L, d, Hkv, hd), 1 / math.sqrt(d)),
             ("layers.attn.wo", (L, Hq, hd, d), 1 / math.sqrt(Hq * hd))]
    if model.get("run_as", {}).get("qk_norm"):
        specs += [("layers.attn.q_norm", (L, hd), 0.0),
                  ("layers.attn.k_norm", (L, hd), 0.0)]
    specs.append(("layers.ln2.scale", (L, d), 0.0))
    if model.get("num_local_experts"):
        E = model["num_local_experts"]
        specs += [("layers.moe.router", (L, d, E), 1 / math.sqrt(d)),
                  ("layers.moe.w_gate", (L, E, d, ff), 1 / math.sqrt(d)),
                  ("layers.moe.w_up", (L, E, d, ff), 1 / math.sqrt(d)),
                  ("layers.moe.w_down", (L, E, ff, d), 1 / math.sqrt(ff))]
    else:
        specs += [("layers.mlp.w_gate", (L, d, ff), 1 / math.sqrt(d)),
                  ("layers.mlp.w_up", (L, d, ff), 1 / math.sqrt(d)),
                  ("layers.mlp.w_down", (L, ff, d), 1 / math.sqrt(ff))]
    specs.append(("final_norm.scale", (d,), 0.0))
    return specs


def draw_leaf(seed: int, name: str, shape, std: float,
              device) -> torch.Tensor:
    if std == 0.0:
        return torch.ones(shape, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(derive(seed, "w", name))
    x = torch.randn(shape, dtype=torch.float32, device=device, generator=gen)
    return x.mul_(std)


def set_leaf(tree: Tree, name: str, x) -> None:
    *path, last = name.split(".")
    node = tree
    for p in path:
        node = node.setdefault(p, {})
    node[last] = x


def draw_weights(model: Dict, seed: int, device) -> Tree:
    """The whole tree, one draw a stacked leaf."""
    tree: Tree = {}
    for name, shape, std in leaf_specs(model):
        set_leaf(tree, name, draw_leaf(seed, name, shape, std, device))
    return tree


def train_tokens(seed: int, step: int, B: int, S: int, vocab: int,
                 device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step ``step``'s (tokens, labels), each [B, S] int64."""
    gen = torch.Generator(device=device).manual_seed(
        derive(seed, "train", step))
    x = torch.randint(0, vocab, (B, S + 1), generator=gen, device=device)
    return x[:, :S], x[:, 1:]


def request_tokens(seed: int, index: int, B: int, S: int, vocab: int,
                   device) -> torch.Tensor:
    """Serve request ``index``'s [B, S] int64 prompt."""
    gen = torch.Generator(device=device).manual_seed(
        derive(seed, "serve", index))
    return torch.randint(0, vocab, (B, S), generator=gen, device=device)
