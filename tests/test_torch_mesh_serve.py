"""Sharded prefill and decode of every family on the CPU: four gloo ranks on
a ``(2, 2)`` and on a ``(1, 4)`` ``("data", "model")`` mesh, spawned from
this process (``tests/torch_mesh_ranks.py``, kind ``"serve"``), against
the one-process port on the same bridged weights (the reference's init)
and the same numpy-seeded prompts and forced tokens.

Each configuration is reduced and in float32, served twice: with
``serve_param_fsdp`` (the parameters FSDP over "data") and without it
(replicated over "data").  The hybrid's window is 8 slots, shorter than
the 8-token prompt and 8 decode steps, so its ring buffers wrap; on
"model" they are split two (on (2, 2)) and four (on (1, 4)) ways.  A
prefill of 8 tokens and 8 decode steps fill a 16-slot cache.

Tolerances: each step's logits within 1e-4 of the largest |logit| of the
one-process run, and each rank's caches (the prefill's and the final
ones) within 1e-4 of the largest entry of the one-process cache's shard
under ``cache_specs``: the ranks sum partial products, and the
distributed flash-decode combines partial softmaxes, in other orders
than one process does.  Two runs on the same mesh are ``torch.equal``:
every sum over ranks is in rank order.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402
import torch_mesh_ranks as ranks  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

torch.set_num_threads(1)
ARCHS = ("qwen3-1.7b", "qwen3-moe-30b-a3b", "qwen2-vl-2b",
         "falcon-mamba-7b", "recurrentgemma-9b", "whisper-medium")
MESHES = ((2, 2), (1, 4))
B, PROMPT, STEPS, CACHE = 4, 8, 8, 16
WINDOW = 8


def _cfgs(arch):
    """(reference config, port config) reduced, float32; the hybrid's
    window cut to WINDOW."""
    jcfg = dataclasses.replace(jreduced(jget_config(arch)),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(reduced(get_config(arch)),
                               compute_dtype="float32")
    if tcfg.family == "hybrid":
        jcfg = dataclasses.replace(jcfg, hybrid=dataclasses.replace(
            jcfg.hybrid, window=WINDOW))
        tcfg = dataclasses.replace(tcfg, hybrid=dataclasses.replace(
            tcfg.hybrid, window=WINDOW))
    return jcfg, tcfg


def _no_fsdp(cfg):
    return dataclasses.replace(cfg, name=cfg.name + "-replicated",
                               serve_param_fsdp=False)


def _prompts(cfg, rng):
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, PROMPT),
                                         dtype=np.int32))
    if cfg.family == "vlm":
        return {"embeds": torch.from_numpy(rng.standard_normal(
            (B, PROMPT, cfg.d_model)).astype(np.float32))}
    if cfg.family == "encdec":
        return {"enc_embeds": torch.from_numpy(rng.standard_normal(
            (B, cfg.encdec.source_positions, cfg.d_model)).astype(
                np.float32)), "tokens": toks}
    return {"tokens": toks}


def _flat(tree, specs):
    """(spec, tensor) pairs of a cache tree and its specs."""
    if torch.is_tensor(tree):
        return [(specs, tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], specs[k])]
    return [x for t, s in zip(tree, specs, strict=True)
            for x in _flat(t, s)]


def _close(what, got, want, scale):
    err = float((got.float() - want.float()).abs().max()) \
        if got.numel() else 0.0
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert err <= 1e-4 * scale + 1e-12, (
        f"{what}: {err} > 1e-4 of {scale}")


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The reference's init of each configuration, bridged and saved; the
    one-process serving runs; each mesh's ranks' runs."""
    tmp = tmp_path_factory.mktemp("serve")
    rng = np.random.default_rng(0)
    out = {"cfgs": {}, "one": {}, "mesh": {}}
    init, prompts, forced, cfgs = {}, {}, {}, []
    for arch in ARCHS:
        jcfg, tcfg = _cfgs(arch)
        tree = jax.tree.map(np.asarray,
                            jbuild_model(jcfg).init(jax.random.PRNGKey(0)))
        params = bridge.params_from_numpy(tree, tcfg, device="cpu")
        path = str(tmp / f"{tcfg.name}.pt")
        torch.save({"params": {n: p.detach() for n, p in
                               params.named_parameters()}}, path)
        pr = _prompts(tcfg, rng)
        fz = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (B, STEPS),
                                           dtype=np.int32))
        for cfg in (tcfg, _no_fsdp(tcfg)):
            init[cfg.name], prompts[cfg.name], forced[cfg.name] = \
                path, pr, fz
            cfgs.append(cfg)
        out["cfgs"][arch] = tcfg
        with torch.inference_mode():
            out["one"][arch] = ranks.serve_run(build_model(tcfg), params,
                                               pr, fz, CACHE)
    for shape in MESHES:
        d = tmp / f"mesh{shape[0]}{shape[1]}"
        d.mkdir()
        mp.spawn(ranks.main, args=(4, dict(
            kind="serve", mesh=shape, cfgs=cfgs, init=init, prompts=prompts,
            forced=forced, cache_len=CACHE, runs=2, out=str(d),
            store=str(d / "store"))), nprocs=4, join=True)
        out["mesh"][shape] = [torch.load(d / f"serve{r}.pt")
                              for r in range(4)]
    return out


CASES = [(s, a, f) for s in MESHES for a in ARCHS for f in (True, False)]


@pytest.mark.parametrize("shape,arch,fsdp", CASES, ids=[
    f"{s[0]}x{s[1]}-{a}-{'fsdp' if f else 'replicated'}"
    for s, a, f in CASES])
def test_sharded_serving_matches_one_process(work, shape, arch, fsdp):
    """Every rank's logits (its batch rows, the whole vocabulary) and
    caches against the one-process run's, its shard of them under
    ``cache_specs``."""
    tcfg = work["cfgs"][arch]
    cfg = tcfg if fsdp else _no_fsdp(tcfg)
    pc1, logits1, caches1 = work["one"][arch]
    am = tmesh.AbstractMesh(shape, ("data", "model"))
    specs = build_model(tcfg).cache_specs()
    scale = float(logits1.abs().max())
    Bl = B // shape[0]
    for r, res in enumerate(work["mesh"][shape]):
        coords = {"data": r // shape[1], "model": r % shape[1]}
        pc, logits, caches = res[(cfg.name, 0)]
        rows = slice(coords["data"] * Bl, (coords["data"] + 1) * Bl)
        _close(f"rank {r} logits", logits, logits1[rows], scale)
        for what, got, want in (("prefill", pc, pc1),
                                ("final", caches, caches1)):
            for i, ((spec, g), (_, w)) in enumerate(zip(
                    _flat(got, specs), _flat(want, specs), strict=True)):
                sp = tmesh.sanitize_spec(spec, tuple(w.shape), am)
                w = w[tmesh.local_slices(sp, w.shape, am, coords)]
                _close(f"rank {r} {what} cache {i}", g, w,
                       float(w.abs().max()))


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_two_mesh_serving_runs_are_equal(work, shape):
    for res in work["mesh"][shape]:
        names = {k[0] for k in res}
        for name in names:
            a, b = res[(name, 0)], res[(name, 1)]
            for x, y in zip(_flat(a, _spec_like(a)), _flat(b, _spec_like(b)),
                            strict=True):
                assert torch.equal(x[1], y[1]), name


def _spec_like(tree):
    """A spec tree of ``tree``'s structure (for ``_flat``)."""
    if torch.is_tensor(tree):
        return None
    if isinstance(tree, dict):
        return {k: _spec_like(v) for k, v in tree.items()}
    return type(tree)(_spec_like(v) for v in tree)
