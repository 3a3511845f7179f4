"""The mesh path of every family: how a model's leaves lie on a ``("data",
"model")`` (or ``("pod", "data", "model")``) mesh, and the collectives at
their uses.  The JAX package gets this from XLA's SPMD partitioner, its
``with_sharding_constraint`` hints and ``moe.py``'s ``shard_map``; here it
is written out.

Layout (``Sharding.specs``, by ``named_parameters`` name): each leaf's
template (the family's ``specs_*``: ``transformer.specs_lm``,
``ssm_lm.specs_ssm_lm``, ``hybrid.specs_hybrid``, ``encdec.specs_encdec``)
resolved and sanitized for the mesh (``launch.mesh.sanitize_spec``), so a
rank stores the spec's shard of every parameter, and of its m and v: FSDP
over the batch axes, tensor or expert parallel over ``"model"``.  The
serving layout (``sharding_for(cfg, mesh, serve=True)``) is the same with
``cfg.serve_param_fsdp`` (the default), and replicated over the batch axes
without it (the reference's ``drop_data``).  A layer's blocks are of five
kinds, told apart by their leaves: attention (``wq``), the RG-LRU block
(``gate_a``), the Mamba block (``A_log``), the MoE (``router``) and the
MLP.  Where the sanitizing drops ``"model"`` from one leaf of a kind's
blocks (heads, ``ff``, experts, channels or gate blocks not divisible by
the axis; or query heads whose kv heads would not split evenly), every
block of that kind drops it and runs replicated over ``"model"``: the
port's counterpart of XLA's uneven padding.  The embedding and the head
split the vocabulary where it divides.

Uses (``layer``, ``top``, ``embed``, ``head``):

* ZeRO-3: a leaf sharded over the batch axes is all-gathered on that
  dimension at its use, inside the rematerialised layer function, so the
  backward pass gathers it again; the gather's backward is a
  reduce-scatter, the sum of the data ranks' gradients.  A leaf replicated
  over the batch axes takes ``reduce_grad`` over them instead (data
  parallelism's all-reduce).  With ``cast_weights_bf16`` the local shard
  is cast first and the bf16 copy gathered (the cast is elementwise: the
  bits of gather-then-cast), the leaves chosen by their global size;
  decode casts nothing, as the reference's decode reads the leaves it is
  given.
* Tensor parallelism: attention splits the query heads (``wq``, ``bq``,
  ``wo``); in training each rank reads the kv heads its query heads use, a
  slice of the replicated ``wk`` / ``wv``, and in serving it projects every
  kv head (the caches hold them all) and attends with its own.  The MLP
  splits ``ff``.  The Mamba block splits its ``d_inner`` channels:
  ``in_proj``'s column block is all-gathered over ``"model"`` and each rank
  keeps its x and z channels, ``x_proj`` is split by rows (its product
  summed over ``"model"``), the conv, ``A_log``, ``D``, ``dt_proj`` and
  the scan are local.  The RG-LRU block splits its ``W`` channels and gate
  blocks (the conv, ``lam`` and the scan local).  A block's input enters
  through ``reduce_grad`` over ``"model"`` and its output leaves through
  ``reduce`` (Megatron's f and g); a leaf replicated over ``"model"`` but
  used inside the block (``wk``, ``wv``, the qk-norm scales, the router)
  takes ``reduce_grad`` over ``"model"`` too, since each rank's gradient
  of it is partial.  The output biases (``bo``, ``b_down``) are added
  after the exit.
* Expert parallelism: ``moe.apply_moe`` with ``moe_ep``.
* The vocabulary: the embedding is a masked local lookup, then a sum over
  ``"model"`` (one rank contributes each row, the others add zeros, so it
  is exact); the head's logits are gathered over ``"model"`` before the
  unchanged cross-entropy.
* The caches (``cache_specs``): K/V split along S over ``"model"`` (the
  distributed flash-decode, ``attention.decode_split``; the hybrid's ring
  buffers along their slots), the recurrent states by channels, whisper's
  cross K/V by heads.  ``seq_chunk`` keeps a rank's slots; a length that
  does not divide over ``"model"`` raises ``ValueError``.

On a mesh whose axes all have size 1 every collective, mask and gather is
skipped, so the mesh path is the one-process computation op for op.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.configs import ModelConfig
from repro_torch.launch.mesh import (P, all_gather, batch_axes_of,
                                     drop_axes, entry_axes, exchange,
                                     gather_split, psum, reduce, reduce_grad,
                                     sanitize_spec, shard, unshard)
from repro_torch.models import encdec as ed
from repro_torch.models import hybrid as hy
from repro_torch.models import ssm_lm as sl
from repro_torch.models import transformer as tf
from repro_torch.models.common import apply_norm, dt
from repro_torch.optim.adamw import global_norm_sharded

MODEL = ("model",)
STACKS = ("layers", "enc_layers", "dec_layers")
# output biases, added after a tensor-parallel block's exit
_POST_EXIT = ("bo", "b_down")
_KV = ("wk", "wv", "bk", "bv")
# family -> (init, parameter templates)
_LAYOUTS = {"dense": (tf.init_lm, tf.specs_lm),
            "moe": (tf.init_lm, tf.specs_lm),
            "vlm": (tf.init_lm, tf.specs_lm),
            "ssm": (sl.init_ssm_lm, sl.specs_ssm_lm),
            "hybrid": (hy.init_hybrid, hy.specs_hybrid),
            "encdec": (ed.init_encdec, ed.specs_encdec)}


def _has_model(spec: P) -> bool:
    return any("model" in entry_axes(e) for e in spec)


def block_kind(leaves: Sequence[str]) -> str:
    """The kind of a layer's block from its leaf names."""
    for leaf, kind in (("wq", "attn"), ("gate_a", "rec"), ("A_log", "mamba"),
                       ("router", "moe"), ("w_down", "mlp")):
        if leaf in leaves:
            return kind
    return "norm"


def _cast_names(params, cfg: ModelConfig) -> set:
    """The leaves the reference's ``cast_weights`` casts (by their stacked
    size)."""
    cd = dt(cfg.compute_dtype)
    if cfg.family == "encdec":
        named = [(n, x, ed._depth(n, cfg)) for n, x in
                 params.named_parameters()]
    else:
        named = tf._named_leaves(params, cfg)
    return {n for n, x, depth in named if cfg.cast_weights_bf16
            and tf._casts(x, depth) and x.dtype != cd}


def sharding_for(cfg: ModelConfig, mesh, serve: bool = False) -> "Sharding":
    """The ``Sharding`` of ``cfg`` on ``mesh`` (the serving layout with
    ``serve``), made once a mesh."""
    serve = serve and not cfg.serve_param_fsdp
    key = ("sharding", cfg, serve)
    if key not in mesh.cache:
        mesh.cache[key] = Sharding(cfg, mesh, serve)
    return mesh.cache[key]


class Sharding:
    """A model's layout on ``mesh`` and its collectives.  ``serve``: the
    parameters replicated over the batch axes (``serve_param_fsdp``
    off)."""

    def __init__(self, cfg: ModelConfig, mesh, serve: bool = False):
        if cfg.family not in _LAYOUTS:
            raise NotImplementedError(f"no model family {cfg.family!r}")
        if cfg.pure_dp:
            raise NotImplementedError(
                "the pure_dp layout (the batch and every leaf over 'data' "
                "and 'model' together) waits: ROADMAP.md")
        self.cfg, self.mesh = cfg, mesh
        self.cd = dt(cfg.compute_dtype)
        self.batch_axes = batch_axes_of(mesh)
        self.data_size = mesh.axis_size(self.batch_axes)
        self.model_size = mesh.shape.get("model", 1)
        self.model_index = mesh.coords.get("model", 0) \
            if hasattr(mesh, "coords") else 0
        init, specs_fn = _LAYOUTS[cfg.family]
        meta = init(torch.Generator(), cfg, torch.device("meta"))
        self.shapes = {n: tuple(x.shape) for n, x in meta.named_parameters()}
        cast = _cast_names(meta, cfg)
        templates = specs_fn(cfg)
        if serve:
            templates = {n: drop_axes(s, ("data",))
                         for n, s in templates.items()}
        specs = {n: sanitize_spec(templates[n], self.shapes[n], mesh)
                 for n in self.shapes}
        for n, s in specs.items():
            for e in s:
                axes = entry_axes(e)
                if "model" in axes and len(axes) > 1:
                    raise NotImplementedError(
                        f"{n}: spec {s} splits one dimension over 'model' "
                        f"and other axes (the pure_dp layout)")

        # blocks: (stack, layer, sub) -> leaf names
        blocks: Dict[Tuple[str, int, str], List[str]] = {}
        for n in specs:
            parts = n.split(".")
            if parts[0] in STACKS:
                blocks.setdefault((parts[0], int(parts[1]), parts[2]),
                                  []).append(parts[3])
        self._kind = {b: block_kind(leaves) for b, leaves in blocks.items()}
        # a kind is split over "model" only if every leaf of its blocks that
        # the template splits keeps the split
        split: Dict[str, bool] = {}
        for b, leaves in blocks.items():
            kind = self._kind[b]
            names = [".".join((b[0], str(b[1]), b[2], k)) for k in leaves]
            keys = [n for n in names if _has_model(templates[n])]
            if not keys:
                continue
            ok = self.model_size > 1 and all(_has_model(specs[n])
                                             for n in keys)
            split[kind] = split.get(kind, True) and ok
        self.kv = self.heads = None
        if split.get("attn"):
            Hq, Hkv = cfg.num_heads, cfg.num_kv_heads
            Hl, G = Hq // self.model_size, Hq // Hkv
            if Hl % G and G % Hl:
                split["attn"] = False
            else:
                r = self.model_index
                self.kv = slice(r * Hl // G, ((r + 1) * Hl - 1) // G + 1)
                self.heads = slice(r * Hl, (r + 1) * Hl)
        self.tp = {k: split.get(k, False)
                   for k in ("attn", "mlp", "moe", "rec", "mamba")}
        self.attn_tp, self.mlp_tp, self.moe_ep = (
            self.tp["attn"], self.tp["mlp"], self.tp["moe"])
        for b, leaves in blocks.items():
            if not self.tp.get(self._kind[b], False):
                for k in leaves:
                    n = ".".join((b[0], str(b[1]), b[2], k))
                    specs[n] = drop_axes(specs[n], MODEL)
        self.specs: Dict[str, P] = specs
        self.vocab_tp = {n: _has_model(specs[n])
                         for n in ("embed", "lm_head") if n in specs}

        def info(name: str, kind: str, leaf: str):
            tp_rep = (self.tp.get(kind, False) and leaf not in _POST_EXIT
                      and not _has_model(specs[name]))
            return specs[name], tp_rep, name in cast

        self._layers: Dict[Tuple[str, int], Dict[str, tuple]] = {}
        for b, leaves in blocks.items():
            d = self._layers.setdefault(b[:2], {})
            for k in leaves:
                d[f"{b[2]}.{k}"] = info(".".join((b[0], str(b[1]), b[2], k)),
                                        self._kind[b], k)
        self._top = {n: info(n, "top", n) for n in specs
                     if n.split(".")[0] not in STACKS}

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

    def top(self, name: str, x: torch.Tensor, cast: bool = True
            ) -> torch.Tensor:
        """A leaf outside the layers (``embed``, ``lm_head``, the final
        norms, encdec's position tables) at its use."""
        spec, tp_rep, c = self._top[name]
        return self._use(x, spec, tp_rep, c and cast)

    def layer(self, lp, i: int = 0, stack: str = "layers", *,
              serve: bool = False, cast: bool = True
              ) -> Dict[str, Dict[str, torch.Tensor]]:
        """Layer ``i`` of ``stack``'s leaves at their use: ``{sub: {leaf:
        tensor}}``.  In training the attention's kv weights are sliced to
        the kv heads this rank's query heads read; ``serve`` keeps them
        whole.  ``cast=False`` (decode) casts nothing."""
        infos = self._layers[(stack, i)]
        out = {}
        for sub, pd in lp.items():
            leaves = {}
            for k, x in pd.items():
                spec, tp_rep, c = infos[f"{sub}.{k}"]
                x = self._use(x, spec, tp_rep, c and cast)
                if (self.kv is not None and not serve and k in _KV
                        and self._kind[(stack, i, sub)] == "attn"):
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

    def exit_if(self, kind: str):
        """``exit_tp`` where blocks of ``kind`` are split, else ``None``
        (the ``reduce`` argument of the blocks' functions)."""
        return self.exit_tp if self.tp[kind] else None

    def sum_tp(self, y: torch.Tensor) -> torch.Tensor:
        """A partial product summed over ``"model"`` inside a split block
        (the Mamba block's ``x_proj``): all-reduce forward and backward."""
        return reduce_grad(reduce(y, MODEL, self.mesh), MODEL, self.mesh)

    def split_xz(self, xz: torch.Tensor):
        """The Mamba block's ``x`` and ``z`` channels of this rank from its
        column block of ``in_proj``'s product ``xz`` [..., 2c]: the block
        holds chunks 2r and 2r + 1 of the 2m chunks of c channels (x's m,
        then z's m), and rank j needs chunks j and m + j, so one all-to-all
        over ``"model"`` moves each chunk to its rank (each rank receives
        2c channels, where an all-gather would bring it 2mc)."""
        m, r = self.model_size, self.model_index
        c = xz.shape[-1] // 2
        dest = [(2 * r) % m, (2 * r + 1) % m]        # of chunks 2r, 2r + 1
        send = [c * dest.count(j) for j in range(m)]
        recv = [0] * m
        recv[r // 2] += c                              # chunk r, from r // 2
        recv[(m + r) // 2] += c                        # chunk m + r
        t = xz.movedim(-1, 0)
        parts = t.split(c)
        if dest[0] > dest[1]:                          # sent in rank order
            t = torch.cat([parts[1], parts[0]])
        got = exchange(t, send, recv, MODEL, self.mesh).movedim(0, -1)
        return got[..., :c], got[..., c:]

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

    def head(self, params, h: torch.Tensor, norm: str = "final_norm",
             cast: bool = True) -> torch.Tensor:
        """The final norm and the head; the logits' vocabulary gathered
        over ``"model"`` where the head splits it."""
        norm_p = {k: self.top(f"{norm}.{k}", v, cast)
                  for k, v in getattr(params, norm).items()}
        h = apply_norm(norm_p, h, self.cfg.norm)
        name = "embed" if self.cfg.tie_embeddings else "lm_head"
        w = self.top(name, getattr(params, name), cast)
        split = self.vocab_tp[name]
        h = self.enter(h, split)
        logits = h @ w.to(h.dtype).T if name == "embed" \
            else h @ w.to(h.dtype)
        return gather_split(logits, -1, MODEL, self.mesh) if split \
            else logits

    # -- the caches ---------------------------------------------------------

    def local_batch(self, n: int) -> int:
        """A rank's part of a global batch of ``n`` (``n`` itself where it
        does not divide over the batch axes, as the specs' sanitizing
        replicates it)."""
        return n // self.data_size if n % self.data_size == 0 else n

    def local_len(self, n: int) -> int:
        """A rank's slots of a cache of ``n`` slots split over
        ``"model"``."""
        if not self.seq_split:
            return n
        if n % self.model_size:
            raise ValueError(f"{n} cache slots do not split over the "
                             f"{self.model_size} ranks of 'model' (the "
                             f"distributed flash-decode splits them)")
        return n // self.model_size

    @property
    def seq_split(self) -> bool:
        """Whether the K/V caches (and ring buffers) split their slots over
        ``"model"``."""
        return self.model_size > 1

    def seq_chunk(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slots of ``x`` along ``dim``: the ``"model"``
        coordinate's chunk (``x`` itself on a ``"model"`` axis of 1)."""
        if not self.seq_split:
            return x
        c = self.local_len(x.shape[dim])
        return x.narrow(dim, self.model_index * c, c).contiguous()

    def cross_len(self, n: int) -> int:
        """A rank's heads of a cross K/V cache of ``n`` heads: split over
        ``"model"`` where they divide (whisper's ``cache_specs``)."""
        m = self.model_size
        return n // m if m > 1 and n % m == 0 else n

    def cross_chunk(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's heads (dim 2) of a cross K/V ``x``."""
        c = self.cross_len(x.shape[2])
        if c == x.shape[2]:
            return x
        return x.narrow(2, self.model_index * c, c).contiguous()

    def cross_heads(self, x: torch.Tensor) -> torch.Tensor:
        """The heads this rank's cross-attention queries read from its
        cross K/V cache ``x`` [B, F, H, hd]: all of it where the cache
        splits the heads (they are the rank's own: a split cache implies
        split attention) or where attention runs replicated, else the
        slice of a whole cache."""
        if self.attn_tp and x.shape[2] == self.cfg.num_kv_heads:
            return x[:, :, self.kv]
        return x

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

