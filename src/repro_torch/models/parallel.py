"""The mesh path of the dense, moe and vlm families: how an ``LM``'s leaves
lie on a ``("data", "model")`` (or ``("pod", "data", "model")``) mesh, and
the collectives at their uses.  The JAX package gets this from XLA's SPMD
partitioner, its ``with_sharding_constraint`` hints and ``moe.py``'s
``shard_map``; here it is written out.

Layout (``Sharding.specs``, by ``named_parameters`` name): each leaf's
template (``transformer.specs_lm``) resolved and sanitized for the mesh
(``launch.mesh.sanitize_spec``), so a rank stores the spec's shard of every
parameter, and of its m and v: FSDP over the batch axes, tensor or expert
parallel over ``"model"``.  Where the sanitizing drops ``"model"`` from one
leaf of a block (heads, ``ff`` or experts not divisible by the axis; or
query heads whose kv heads would not split evenly), the whole block drops
it and runs replicated over ``"model"``: the port's counterpart of XLA's
uneven padding.  The embedding and the head split the vocabulary where it
divides.

Uses (``layer``, ``embed``, ``head``):

* ZeRO-3: a leaf sharded over the batch axes is all-gathered on that
  dimension at its use, inside the rematerialised layer function, so the
  backward pass gathers it again; the gather's backward is a
  reduce-scatter, the sum of the data ranks' gradients.  A leaf replicated
  over the batch axes takes ``reduce_grad`` over them instead (data
  parallelism's all-reduce).  With ``cast_weights_bf16`` the local shard
  is cast first and the bf16 copy gathered (the cast is elementwise: the
  bits of gather-then-cast), the leaves chosen by their global size.
* Tensor parallelism: attention splits the query heads (``wq``, ``bq``,
  ``wo``); each rank reads the kv heads its query heads use, a slice of
  the replicated ``wk`` / ``wv``.  The MLP splits ``ff`` (``w_gate``,
  ``w_up``, ``w_down``).  A block's input enters through ``reduce_grad``
  over ``"model"`` and its output leaves through ``reduce`` (Megatron's f
  and g); a leaf replicated over ``"model"`` but used inside the block
  (``wk``, ``wv``, the qk-norm scales, the router) takes ``reduce_grad``
  over ``"model"`` too, since each rank's gradient of it is partial.  The
  output biases (``bo``, ``b_down``) are added after the exit.
* Expert parallelism: ``moe.apply_moe`` with ``moe_ep``.
* The vocabulary: the embedding is a masked local lookup, then a sum over
  ``"model"`` (one rank contributes each row, the others add zeros, so it
  is exact); the head's logits are gathered over ``"model"`` before the
  unchanged cross-entropy.

On a mesh whose axes all have size 1 every collective, mask and gather is
skipped, so the mesh path is the one-process computation op for op.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.configs import ModelConfig
from repro_torch.launch.mesh import (P, all_gather, batch_axes_of,
                                     drop_axes, entry_axes, gather_split,
                                     psum, reduce, reduce_grad,
                                     sanitize_spec, shard, unshard)
from repro_torch.models import transformer as tf
from repro_torch.models.common import apply_norm, dt
from repro_torch.optim.adamw import global_norm_sharded

MODEL = ("model",)
# output biases, added after a tensor-parallel block's exit
_POST_EXIT = ("attn.bo", "mlp.b_down")
_BLOCKS = ("attn", "mlp", "moe")


def _has_model(spec: P) -> bool:
    return any("model" in entry_axes(e) for e in spec)


def sharding_for(cfg: ModelConfig, mesh) -> "Sharding":
    """The ``Sharding`` of ``cfg`` on ``mesh``, made once a mesh."""
    key = ("sharding", cfg)
    if key not in mesh.cache:
        mesh.cache[key] = Sharding(cfg, mesh)
    return mesh.cache[key]


class Sharding:
    """An ``LM``'s layout on ``mesh`` and its collectives."""

    def __init__(self, cfg: ModelConfig, mesh):
        tf._check_family(cfg)
        self.cfg, self.mesh = cfg, mesh
        self.cd = dt(cfg.compute_dtype)
        self.batch_axes = batch_axes_of(mesh)
        self.data_size = mesh.axis_size(self.batch_axes)
        self.model_size = mesh.shape.get("model", 1)
        self.model_index = mesh.coords.get("model", 0) \
            if hasattr(mesh, "coords") else 0
        meta = tf.init_lm(torch.Generator(), cfg, torch.device("meta"))
        leaves = tf._named_leaves(meta, cfg)
        self.shapes = {n: tuple(x.shape) for n, x, _ in leaves}
        cast = {n for n, x, depth in leaves if cfg.cast_weights_bf16
                and tf._casts(x, depth) and x.dtype != self.cd}
        templates = tf.specs_lm(cfg)
        specs = {n: sanitize_spec(templates[n], self.shapes[n], mesh)
                 for n in self.shapes}
        for n, s in specs.items():
            for e in s:
                axes = entry_axes(e)
                if "model" in axes and len(axes) > 1:
                    raise NotImplementedError(
                        f"{n}: spec {s} splits one dimension over 'model' "
                        f"and other axes (the pure_dp layout)")

        # a block is split over "model" only if every leaf of it that the
        # template splits keeps the split
        layer0 = {n[len("layers.0."):]: s for n, s in specs.items()
                  if n.startswith("layers.0.")}
        tmpl0 = {n[len("layers.0."):]: s for n, s in templates.items()
                 if n.startswith("layers.0.")}
        split = {}
        for block in _BLOCKS:
            keys = [k for k in tmpl0 if k.startswith(block + ".")
                    and _has_model(tmpl0[k])]
            split[block] = (self.model_size > 1 and bool(keys)
                            and all(_has_model(layer0[k]) for k in keys))
        self.kv = None
        if split["attn"]:
            Hq, Hkv = cfg.num_heads, cfg.num_kv_heads
            Hl, G = Hq // self.model_size, Hq // Hkv
            if Hl % G and G % Hl:
                split["attn"] = False
            else:
                r = self.model_index
                self.kv = slice(r * Hl // G, ((r + 1) * Hl - 1) // G + 1)
        self.attn_tp, self.mlp_tp, self.moe_ep = (
            split["attn"], split["mlp"], split["moe"])
        for n in specs:
            sub = n.split(".")[2] if n.startswith("layers.") else None
            if sub in split and not split[sub]:
                specs[n] = drop_axes(specs[n], MODEL)
        self.specs: Dict[str, P] = specs
        self.vocab_tp = {n: _has_model(specs[n])
                         for n in ("embed", "lm_head") if n in specs}

        def info(name: str, key: str):
            block = key.split(".")[0]
            tp_rep = (split.get(block, False) and key not in _POST_EXIT
                      and not _has_model(specs[name]))
            return specs[name], tp_rep, name in cast

        self._layer = {k: info(f"layers.0.{k}", k) for k in layer0}
        self._top = {n: info(n, n) for n in specs
                     if not n.startswith("layers.")}

    # -- uses -------------------------------------------------------------

    def _use(self, x: torch.Tensor, spec: P, tp_rep: bool, cast: bool
             ) -> torch.Tensor:
        if cast:
            x = x.to(self.cd)
        gathered = False
        for d, e in enumerate(spec):
            axes = entry_axes(e)
            if axes and "model" not in axes:
                x = all_gather(x, d, axes, self.mesh)
                gathered = True
        if not gathered:
            x = reduce_grad(x, self.batch_axes, self.mesh)
        if tp_rep:
            x = reduce_grad(x, MODEL, self.mesh)
        return x

    def top(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """A leaf outside the layers (``embed``, ``lm_head``,
        ``final_norm.*``) at its use."""
        return self._use(x, *self._top[name])

    def layer(self, lp) -> Dict[str, Dict[str, torch.Tensor]]:
        """A layer's leaves at their use: ``{sub: {leaf: tensor}}``."""
        out = {}
        for sub, pd in lp.items():
            leaves = {}
            for k, x in pd.items():
                key = f"{sub}.{k}"
                x = self._use(x, *self._layer[key])
                if self.kv is not None and key in ("attn.wk", "attn.wv",
                                                   "attn.bk", "attn.bv"):
                    x = x[:, self.kv] if x.dim() == 3 else x[self.kv]
                leaves[k] = x
            out[sub] = leaves
        return out

    def enter(self, x: torch.Tensor, split: bool) -> torch.Tensor:
        """Into a block split over ``"model"`` (``split``): identity
        forward, the cotangent summed over ``"model"``."""
        return reduce_grad(x, MODEL, self.mesh) if split else x

    def exit_tp(self, y: torch.Tensor) -> torch.Tensor:
        """Out of a block split over ``"model"``: the ranks' partial
        outputs summed; identity backward."""
        return reduce(y, MODEL, self.mesh)

    def model_sum(self, x: torch.Tensor) -> torch.Tensor:
        return psum(x, MODEL, self.mesh)

    def batch_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the batch axes (outside autograd)."""
        return psum(x, self.batch_axes, self.mesh)

    def embed(self, table: torch.Tensor, tokens: torch.Tensor,
              cd: torch.dtype) -> torch.Tensor:
        """The token embedding: on a vocabulary split over ``"model"``, a
        masked lookup of the rank's rows summed over ``"model"``."""
        w = self.top("embed", table)
        if not self.vocab_tp["embed"]:
            return w[tokens].to(cd)
        Vl = w.shape[0]
        local = tokens.long() - self.model_index * Vl
        ok = (local >= 0) & (local < Vl)
        h = w[local.clamp(0, Vl - 1)]
        h = torch.where(ok[..., None], h, torch.zeros(
            (), dtype=h.dtype, device=h.device)).to(cd)
        return reduce(h, MODEL, self.mesh)

    def head(self, params, h: torch.Tensor) -> torch.Tensor:
        """The final norm and the head; the logits' vocabulary gathered
        over ``"model"`` where the head splits it."""
        norm = {k: self.top(f"final_norm.{k}", v)
                for k, v in params.final_norm.items()}
        h = apply_norm(norm, h, self.cfg.norm)
        name = "embed" if self.cfg.tie_embeddings else "lm_head"
        w = self.top(name, getattr(params, name))
        split = self.vocab_tp[name]
        h = self.enter(h, split)
        logits = h @ w.to(h.dtype).T if name == "embed" \
            else h @ w.to(h.dtype)
        return gather_split(logits, -1, MODEL, self.mesh) if split \
            else logits

    # -- layout -----------------------------------------------------------

    def sharded_axes(self, name: str) -> Tuple[str, ...]:
        """The mesh axes (of size > 1) that split leaf ``name``."""
        axes = {a for e in self.specs[name] for a in entry_axes(e)}
        return tuple(a for a in self.mesh.axis_names
                     if a in axes and self.mesh.shape[a] > 1)

    def shard(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return shard(x, self.specs[name], self.mesh)

    def unshard(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return unshard(x, self.specs[name], self.mesh)

    def grad_norm(self, names: Sequence[str], leaves: List[torch.Tensor]
                  ) -> torch.Tensor:
        return global_norm_sharded(
            leaves, [self.sharded_axes(n) for n in names], self.mesh)
