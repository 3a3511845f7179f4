"""The benchmark's plain reference against the port's CPU path, at reduced
sizes and in float32 (where the two compute the same mathematics and
differ by rounding alone), and the reference's imports.

    PYTHONPATH=src python -m pytest -q bench/tests/test_bench_reference.py
"""
from __future__ import annotations

import ast
import copy
import dataclasses
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

from harness import program  # noqa: E402
from harness.common import load_json  # noqa: E402
from harness.weights import draw_weights, train_tokens  # noqa: E402
from reference import decoder as ref  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "repro", "repro_torch"}


def tiny(config: str, **kw):
    m = copy.deepcopy(load_json(BENCH / "configs" / f"{config}.json"))
    m.update(num_hidden_layers=3, hidden_size=64, num_attention_heads=4,
             num_key_value_heads=2, head_dim=16, vocab_size=128,
             intermediate_size=48)
    if m.get("num_local_experts"):
        m.update(num_local_experts=8, num_experts_per_tok=2)
    m["run_as"] = dict(m["run_as"], **kw)
    return m


def f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


@pytest.mark.parametrize("config,kw", [
    ("qwen3-1.7b", {}),
    ("granite-moe-1b-a400m", {}),
    # a capacity that drops assignments: the slots must agree too
    ("granite-moe-1b-a400m", {"capacity_factor": 0.5}),
])
def test_forward_matches_port(config, kw):
    m = tiny(config, **kw)
    tree = draw_weights(m, 7, "cpu")
    tokens = torch.randint(0, m["vocab_size"], (2, 24),
                           generator=torch.Generator().manual_seed(3))
    cfg = f32(program.port_config(m))
    lm = program.port_lm(cfg, tree)
    from repro_torch.models.transformer import forward
    with torch.no_grad():
        want = forward(lm, cfg, {"tokens": tokens}, mode="prefill")[0]
        hn = ref.hidden(tree, m, tokens, m["num_hidden_layers"], ref.FP32)
        got = torch.stack([ref.logits(hn[b], tree, ref.FP32)
                           for b in range(2)])
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("config", ["qwen3-1.7b", "granite-moe-1b-a400m"])
def test_loss_and_gradients_match_port(config):
    m = tiny(config)
    tree = draw_weights(m, 11, "cpu")
    tokens, labels = train_tokens(11, 1, 2, 16, m["vocab_size"], "cpu")
    cfg = f32(program.port_config(m))
    state = program.train_state(cfg, tree)
    from repro_torch.models import build_model
    params = dict(state.params.named_parameters())
    loss, _ = build_model(cfg).loss(state.params, {"tokens": tokens,
                                                   "labels": labels})
    grads = torch.autograd.grad(loss, list(params.values()))
    got_loss, got = ref.loss_and_grads(draw_weights(m, 11, "cpu"), m,
                                       tokens, labels, ref.FP32)
    assert abs(float(loss.detach()) - float(got_loss)) < 1e-5
    ref_norms = ref.leaf_norms(got)
    for (name, g) in zip(params, grads):
        assert abs(float(g.norm()) - ref_norms[name]) <= 1e-4 * max(
            ref_norms[name], 1e-6), name


def test_clip_and_adamw_match_port():
    from repro_torch.optim import OptConfig, apply_updates, init_opt
    gen = torch.Generator().manual_seed(5)
    shapes = {"a": (7, 5), "b": (11,), "c": (3, 4, 2)}
    p0 = {n: torch.randn(s, generator=gen) for n, s in shapes.items()}
    grads = [{n: torch.randn(s, generator=gen) * 3 for n, s in shapes.items()}
             for _ in range(3)]
    opt = dict(lr=1e-3, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1,
               grad_clip=1.0, warmup_steps=2, total_steps=10,
               min_lr_frac=0.1)
    port = {n: x.clone() for n, x in p0.items()}
    state = init_opt(port)
    mine = {n: x.clone() for n, x in p0.items()}
    m = {n: torch.zeros_like(x) for n, x in mine.items()}
    v = {n: torch.zeros_like(x) for n, x in mine.items()}
    for j, g in enumerate(grads, start=1):
        _, state, _ = apply_updates(port, {n: x.clone() for n, x in g.items()},
                                    state, OptConfig(**opt))
        cg, _ = ref.clip(g, opt["grad_clip"])
        ref.adamw(mine, cg, m, v, j, opt)
    for n in shapes:
        torch.testing.assert_close(mine[n], port[n], rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(m[n], state.m[n], rtol=1e-6, atol=1e-7)


def test_fp8_control_departs_from_fp32():
    m = tiny("qwen3-1.7b")
    tree = draw_weights(m, 9, "cpu")
    tokens = torch.randint(0, m["vocab_size"], (2, 24),
                           generator=torch.Generator().manual_seed(1))
    a = ref.hidden(tree, m, tokens, 3, ref.FP32)
    b = ref.hidden(tree, m, tokens, 3, ref.FP8)
    rel = float((a - b).norm() / a.norm())
    assert 1e-3 < rel < 0.5


@pytest.mark.parametrize("config", ["qwen3-1.7b", "granite-moe-1b-a400m"])
def test_the_drawn_leaves_are_the_ports_leaves(config):
    m = tiny(config)
    tree = draw_weights(m, 1, "cpu")
    lm = program.port_lm(program.port_config(m), tree)
    # the reference's norms by leaf name cover every parameter of the port
    assert set(ref.leaf_norms(ref.flat(tree))) == {
        n for n, _ in lm.named_parameters()}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in _imports(path) if name}
    assert not tops & FORBIDDEN, tops & FORBIDDEN


def test_reference_import_check_compares_whole_names():
    # repro_torch is the program and is refused; a module whose name only
    # begins like a forbidden one is not
    assert {"repro_torch"} & FORBIDDEN
    assert not {"reprox", "jaxtyping"} & FORBIDDEN
