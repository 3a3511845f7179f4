"""The plain reference: a decoder-only LM (dense or mixture of experts) in
float32 PyTorch, its cross-entropy, gradients, global-norm clip and AdamW.

It follows the published architectures as the configuration files state
them (Hugging Face key names): token embedding; per layer an RMSNorm,
grouped-query attention with rotary embeddings (half rotation) and, where
``run_as.qk_norm`` is set, an RMSNorm over each head's q and k before the
rotation, the output projection and the residual; an RMSNorm, then either a
SwiGLU MLP or a mixture of experts, and the residual; a final RMSNorm and
the head tied to the embedding.  The mixture of experts routes by a float32
softmax over the router's logits, takes the top k by a stable descending
sort, renormalises the k gates where ``run_as.router_norm_topk`` says so,
and gives each expert ``ceil(T·k/E · capacity_factor)`` slots, filled in
token-major order; an assignment beyond them is dropped.

Every product goes through a ``Numerics``: ``FP32`` computes in float32
with TF32 off; ``FP8`` rounds both operands of every product (forward and
backward) to float8 e4m3 with a per-tensor scale and accumulates in
float32, the precision below the configurations' bf16 compute, which is
the control of the comparison.

Memory: training recomputes each layer in the backward pass
(``torch.utils.checkpoint``), attention runs in query chunks against the
keys up to the chunk's end, and the head and the loss run in sequence
chunks, so a full-width model at 2 x 4,096 tokens fits beside its float32
state.

Imports torch alone: nothing of the program or of the JAX package.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

E4M3_MAX = 448.0


def plain_mode() -> None:
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _q8(x: torch.Tensor) -> torch.Tensor:
    if x.numel() == 0:              # an expert that no token reached
        return x
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    s = E4M3_MAX / amax
    return (x * s).to(torch.float8_e4m3fn).to(torch.float32) / s


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _q8(a), _q8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _q8(g)
        return qg @ _q8(qb).transpose(-1, -2), \
            _q8(qa).transpose(-1, -2) @ qg


class Numerics:
    def __init__(self, name: str):
        self.name = name

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "fp8":
            return _Fp8Matmul.apply(a, b)
        return a @ b


FP32 = Numerics("fp32")
FP8 = Numerics("fp8")


# ---------------------------------------------------------------------------
# the architecture
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope_tables(S: int, hd: int, theta: float, device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    half = hd // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float64,
                                       device=device) / half)
    ang = torch.arange(S, dtype=torch.float64, device=device)[:, None] * inv
    ang = torch.cat([ang, ang], dim=-1)
    return ang.cos().float(), ang.sin().float()


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
         ) -> torch.Tensor:
    """x [B, S, H, hd]; the half-rotation layout."""
    x1, x2 = x.chunk(2, dim=-1)
    rot = torch.cat([-x2, x1], dim=-1)
    return x * cos[None, :, None] + rot * sin[None, :, None]


def attention(q, k, v, nm: Numerics, chunk: int = 512) -> torch.Tensor:
    """Causal grouped-query attention: q [B, S, Hq, hd], k and v [B, S,
    Hkv, hd] -> [B, S, Hq, hd]; a query chunk against the keys up to its
    end, a float32 softmax."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.permute(0, 2, 1, 3).reshape(B, Hkv, G, S, hd)
    kt = k.permute(0, 2, 3, 1)[:, :, None]               # [B, Hkv, 1, hd, S]
    vv = v.permute(0, 2, 1, 3)[:, :, None]               # [B, Hkv, 1, S, hd]
    scale = 1.0 / math.sqrt(hd)
    outs = []
    for c0 in range(0, S, chunk):
        c1 = min(c0 + chunk, S)
        s = nm.mm(qg[:, :, :, c0:c1],
                  kt[..., :c1].expand(B, Hkv, G, hd, c1)) * scale
        qi = torch.arange(c0, c1, device=q.device)[:, None]
        ki = torch.arange(c1, device=q.device)[None, :]
        s = s.masked_fill(ki > qi, float("-inf"))
        p = torch.softmax(s, dim=-1)
        outs.append(nm.mm(p, vv[:, :, :, :c1].expand(B, Hkv, G, c1, hd)))
    o = torch.cat(outs, dim=3)                           # [B, Hkv, G, S, hd]
    return o.reshape(B, Hq, S, hd).permute(0, 2, 1, 3)


def capacity(T: int, k: int, E: int, cf: float) -> int:
    return max(1, math.ceil(T * k / E * cf))


def route(x2d, router, model: Dict, nm: Numerics):
    """(gates [T, k], experts [T, k]) of a [T, d] batch."""
    k = model["num_experts_per_tok"]
    probs = torch.softmax(nm.mm(x2d, router), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    if model["run_as"].get("router_norm_topk"):
        vals = vals / vals.sum(-1, keepdim=True)
    return vals, idx


def moe(x2d, p: Dict, i: int, model: Dict, nm: Numerics) -> torch.Tensor:
    T, _ = x2d.shape
    E, k = model["num_local_experts"], model["num_experts_per_tok"]
    C = capacity(T, k, E, model["run_as"]["capacity_factor"])
    gates, idx = route(x2d, p["router"][i], model, nm)
    eid = idx.reshape(-1)                                 # token-major
    onehot = F.one_hot(eid, E)
    slot = (onehot.cumsum(0) - 1).gather(1, eid[:, None])[:, 0]
    keep = slot < C
    tok = torch.arange(T, device=x2d.device).repeat_interleave(k)
    g = gates.reshape(-1)
    y = torch.zeros_like(x2d)
    for e in range(E):
        sel = (eid == e) & keep
        t = tok[sel]
        xe = x2d[t]
        h = F.silu(nm.mm(xe, p["w_gate"][i, e])) * nm.mm(xe, p["w_up"][i, e])
        y = y.index_add(0, t, nm.mm(h, p["w_down"][i, e]) * g[sel, None])
    return y


def layer(h, lp: Dict, i: int, model: Dict, rope_cs, nm: Numerics):
    """Layer ``i`` of the stacked leaves ``lp`` (``tree['layers']``)."""
    B, S, d = h.shape
    eps = model["rms_norm_eps"]
    Hq, Hkv = model["num_attention_heads"], model["num_key_value_heads"]
    hd = model["head_dim"]
    a = lp["attn"]
    x = rmsnorm(h, lp["ln1"]["scale"][i], eps).reshape(B * S, d)
    q = nm.mm(x, a["wq"][i].reshape(d, Hq * hd)).reshape(B, S, Hq, hd)
    kk = nm.mm(x, a["wk"][i].reshape(d, Hkv * hd)).reshape(B, S, Hkv, hd)
    v = nm.mm(x, a["wv"][i].reshape(d, Hkv * hd)).reshape(B, S, Hkv, hd)
    if "q_norm" in a:
        q = rmsnorm(q, a["q_norm"][i], eps)
        kk = rmsnorm(kk, a["k_norm"][i], eps)
    cos, sin = rope_cs
    q, kk = rope(q, cos, sin), rope(kk, cos, sin)
    o = attention(q, kk, v, nm).reshape(B * S, Hq * hd)
    h = h + nm.mm(o, a["wo"][i].reshape(Hq * hd, d)).reshape(B, S, d)
    x = rmsnorm(h, lp["ln2"]["scale"][i], eps).reshape(B * S, d)
    if "moe" in lp:
        y = moe(x, lp["moe"], i, model, nm)
    else:
        m = lp["mlp"]
        y = nm.mm(F.silu(nm.mm(x, m["w_gate"][i])) * nm.mm(x, m["w_up"][i]),
                  m["w_down"][i])
    return h + y.reshape(B, S, d)


def hidden(tree: Dict, model: Dict, tokens: torch.Tensor, layers: int,
           nm: Numerics, remat: bool = False) -> torch.Tensor:
    """The residual stream after ``layers`` layers, final norm applied."""
    return hiddens(tree, model, tokens, [layers], nm, remat)[layers]


def hiddens(tree: Dict, model: Dict, tokens: torch.Tensor,
            depths: Sequence[int], nm: Numerics, remat: bool = False
            ) -> Dict[int, torch.Tensor]:
    """``hidden`` after each of ``depths`` layers, in one pass."""
    S = tokens.shape[1]
    cs = rope_tables(S, model["head_dim"], float(model["rope_theta"]),
                     tokens.device)
    h = tree["embed"][tokens]
    out = {}
    for i in range(max(depths)):
        if remat:
            h = checkpoint(layer, h, tree["layers"], i, model, cs, nm,
                           use_reentrant=False)
        else:
            h = layer(h, tree["layers"], i, model, cs, nm)
        if i + 1 in depths:
            out[i + 1] = rmsnorm(h, tree["final_norm"]["scale"],
                                 model["rms_norm_eps"])
    return out


def logits(hn: torch.Tensor, tree: Dict, nm: Numerics) -> torch.Tensor:
    return nm.mm(hn, tree["embed"].transpose(0, 1))


# ---------------------------------------------------------------------------
# training: loss, gradients, clip, AdamW
# ---------------------------------------------------------------------------


def _ce_sum(hn, embed, labels, nm: Numerics):
    lf = nm.mm(hn.reshape(-1, hn.shape[-1]), embed.transpose(0, 1))
    gold = lf.gather(-1, labels.reshape(-1, 1))[:, 0]
    return (torch.logsumexp(lf, -1) - gold).sum()


def loss_and_grads(tree: Dict, model: Dict, tokens, labels, nm: Numerics,
                   chunk: int = 1024):
    """Mean cross-entropy over every position and its gradients (a tree
    of the leaves' shapes)."""
    leaves = flat(tree)
    for x in leaves.values():
        x.requires_grad_(True)
    with torch.enable_grad():
        hn = hidden(tree, model, tokens, model["num_hidden_layers"], nm,
                    remat=True)
        S = tokens.shape[1]
        total = sum(checkpoint(_ce_sum, hn[:, c0:c0 + chunk], tree["embed"],
                               labels[:, c0:c0 + chunk], nm,
                               use_reentrant=False)
                    for c0 in range(0, S, chunk))
        loss = total / labels.numel()
        grads = torch.autograd.grad(loss, list(leaves.values()))
    for x in leaves.values():
        x.requires_grad_(False)
    return loss.detach(), dict(zip(leaves, grads))


def flat(tree: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def lr_at(opt: Dict, step: int) -> float:
    """Linear warm-up to ``lr``, then a cosine to ``min_lr_frac·lr``."""
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    prog = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0),
               1.0)
    frac = opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * 0.5 * (
        1 + math.cos(math.pi * prog))
    return opt["lr"] * warm * frac


def clip(grads: Dict[str, torch.Tensor], max_norm: float):
    gn = torch.sqrt(sum(g.square().sum() for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return {n: g * scale for n, g in grads.items()}, gn


@torch.no_grad()
def adamw(params: Dict[str, torch.Tensor], grads, m, v, step: int,
          opt: Dict) -> None:
    """One AdamW update in place; ``step`` counts from 1."""
    lr = lr_at(opt, step)
    b1, b2 = opt["beta1"], opt["beta2"]
    for n, p in params.items():
        g = grads[n]
        m[n].mul_(b1).add_(g * (1 - b1))
        v[n].mul_(b2).add_(g * g * (1 - b2))
        mh = m[n] / (1 - b1 ** step)
        vh = v[n] / (1 - b2 ** step)
        p.sub_(lr * (mh / (vh.sqrt() + opt["eps"]) + opt["weight_decay"] * p))


def leaf_norms(stacked: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Norms by the program's parameter names: a stacked layer leaf
    ``layers.<sub>.<leaf>`` [L, ...] gives ``layers.<i>.<sub>.<leaf>``."""
    out = {}
    for name, x in stacked.items():
        if name.startswith("layers."):
            _, sub, leaf = name.split(".")
            norms = x.reshape(x.shape[0], -1).norm(dim=1).tolist()
            for i, n in enumerate(norms):
                out[f"layers.{i}.{sub}.{leaf}"] = n
        else:
            out[name] = float(x.norm())
    return out


def train_steps(tree: Dict, model: Dict, batches: Sequence, opt: Dict,
                nm: Numerics, initial) -> Dict:
    """Follow the program through ``len(batches)`` steps from ``tree``
    (updated in place).  ``initial(name)`` draws a stacked leaf's initial
    value again.  Returns each step's loss, the first step's clipped
    gradient norms and the parameters' change after the last step, by the
    program's leaf names."""
    params = flat(tree)
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    losses: List[float] = []
    grad_norms: Optional[Dict[str, float]] = None
    for j, (tokens, labels) in enumerate(batches, start=1):
        loss, grads = loss_and_grads(tree, model, tokens, labels, nm)
        grads, _ = clip(grads, opt["grad_clip"])
        if grad_norms is None:
            grad_norms = leaf_norms(grads)
        adamw(params, grads, m, v, j, opt)
        losses.append(float(loss))
        del grads
    del m, v
    change: Dict[str, float] = {}
    for n, p in params.items():
        change.update(leaf_norms({n: p - initial(n)}))
    return {"losses": losses, "grad_norms": grad_norms, "change": change}


# ---------------------------------------------------------------------------
# serving: the gap of a served token below the reference's best
# ---------------------------------------------------------------------------


def _gaps(hn: torch.Tensor, tree: Dict, served: torch.Tensor
          ) -> Tuple[float, float]:
    """The widest and the mean gap, over every position, by which the
    served [B, S] token's float32 logit (of the normed stream ``hn``) lies
    below the best."""
    widest, total = 0.0, 0.0
    for b in range(hn.shape[0]):
        lf = logits(hn[b], tree, FP32)                    # [S, V]
        gap = lf.amax(-1) - lf.gather(-1, served[b][:, None])[:, 0]
        widest = max(widest, float(gap.amax()))
        total += float(gap.sum())
        del lf
    return widest, total / served.numel()


@torch.no_grad()
def served_gap(tree: Dict, model: Dict, tokens: torch.Tensor, layers: int,
               served: torch.Tensor) -> Tuple[float, float]:
    """The widest and the mean gap, over every position, by which the
    served [B, S] token's float32 reference logit lies below the
    reference's best at that position."""
    return _gaps(hidden(tree, model, tokens, layers, FP32), tree, served)


@torch.no_grad()
def control_gaps(tree: Dict, model: Dict, tokens: torch.Tensor,
                 depths: Sequence[int], nm: Numerics
                 ) -> Dict[int, Tuple[float, float]]:
    """At each of ``depths``: ``served_gap`` of the tokens that ``nm``'s
    logits put first at that depth."""
    ref32 = hiddens(tree, model, tokens, depths, FP32)
    low = hiddens(tree, model, tokens, depths, nm)
    out = {}
    for d in depths:
        first = torch.stack([logits(low[d][b], tree, nm).argmax(-1)
                             for b in range(tokens.shape[0])])
        out[d] = _gaps(ref32[d], tree, first)
    return out
