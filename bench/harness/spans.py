"""The program's own spans and counters (``repro_torch.obs.spans``): turned
on and collected around a span window, and read into per-layer numbers.

``spans_on()`` / ``collect_spans()`` import the module lazily; where the
program lacks it they do nothing and return False / None, and every
reader below then returns None.  A window's collection goes into a
``ctx`` as ``ctx["spans"]`` (the span dicts ``collect()`` returns) and
``ctx["counters"]``; each reader takes that ``ctx`` and returns a number,
or None where the window has nothing to read.

Card times are the spans' CUDA-event intervals (on the CPU their host
intervals); ``.bwd`` spans are a region's backward pass."""
from __future__ import annotations

import statistics
from collections import defaultdict
from typing import Dict, List, Optional


def spans_on() -> bool:
    """Turn the program's spans on (anything left from before is
    dropped); False where the program has none."""
    try:
        from repro_torch.obs import spans
    except ImportError:
        return False
    spans.collect()
    spans.enable()
    return True


def collect_spans() -> Optional[Dict]:
    """Turn the program's spans off and return what they recorded
    (``{"spans", "counters"}``); None where the program has none."""
    try:
        from repro_torch.obs import spans
    except ImportError:
        return None
    spans.disable()
    return spans.collect()


def _named(ctx: Dict, *names: str) -> List[Dict]:
    return [s for s in ctx.get("spans") or () if s["name"] in names]


def _card_s(s: Dict) -> float:
    return s["card"][1] - s["card"][0]


def _host_s(s: Dict) -> float:
    return s["host"][1] - s["host"][0]


def _median_ms(values: List[float]) -> Optional[float]:
    return 1e3 * statistics.median(values) if values else None


def _card_share(ctx: Dict, parts, whole: str) -> Optional[float]:
    """Σ card time of the spans named in ``parts`` over Σ card time of the
    ``whole`` spans, %."""
    total = sum(_card_s(s) for s in _named(ctx, whole) if s["card"])
    if total <= 0:
        return None
    return 100.0 * sum(_card_s(s) for s in _named(ctx, *parts)
                       if s["card"]) / total


def stage_ms(ctx: Dict) -> Optional[float]:
    """Median card time of one ``serve.stage``, ms."""
    return _median_ms([_card_s(s) for s in _named(ctx, "serve.stage")
                       if s["card"]])


def head_ms(ctx: Dict) -> Optional[float]:
    """Median card time of one ``serve.head``, ms."""
    return _median_ms([_card_s(s) for s in _named(ctx, "serve.head")
                       if s["card"]])


def engine_host_ms(ctx: Dict) -> Optional[float]:
    """Median host self time of ``serve.step``: its host interval less
    those of its ``serve.stage`` and ``serve.head`` spans, ms."""
    spans = ctx.get("spans") or []
    steps = {i: s for i, s in enumerate(spans) if s["name"] == "serve.step"}
    inner: Dict[int, float] = defaultdict(float)
    for s in spans:
        if s["name"] in ("serve.stage", "serve.head") and \
                s["parent"] in steps:
            inner[s["parent"]] += _host_s(s)
    return _median_ms([_host_s(s) - inner[i] for i, s in steps.items()])


def queue_wait_share(ctx: Dict) -> Optional[float]:
    """Σ ``serve.queue`` over Σ ``serve.request`` (its host start to the
    card end of its head), over the requests finished in the window, %."""
    reqs = {s["attrs"]["request"]: s for s in _named(ctx, "serve.request")
            if s["card"]}
    total = sum(_card_s(s) for s in reqs.values())
    if total <= 0:
        return None
    wait = sum(_host_s(s) for s in _named(ctx, "serve.queue")
               if s["attrs"].get("request") in reqs)
    return 100.0 * wait / total


def moe_route_share(ctx: Dict) -> Optional[float]:
    return _card_share(ctx, ("moe.route",), "serve.step")


def moe_experts_share(ctx: Dict) -> Optional[float]:
    return _card_share(ctx, ("moe.experts",), "serve.step")


def moe_drop_share(ctx: Dict) -> Optional[float]:
    """Assignments dropped by the experts' capacity over all, %."""
    c = ctx.get("counters") or {}
    if not c.get("moe.assignments"):
        return None
    return 100.0 * c.get("moe.dropped", 0) / c["moe.assignments"]


def moe_dispatch_share_train(ctx: Dict) -> Optional[float]:
    return _card_share(ctx, ("moe.dispatch", "moe.dispatch.bwd"),
                       "train.step")


def moe_combine_share_train(ctx: Dict) -> Optional[float]:
    return _card_share(ctx, ("moe.combine", "moe.combine.bwd"),
                       "train.step")


def optimizer_ms(ctx: Dict) -> Optional[float]:
    """Mean card time of ``optim.apply_updates`` (one a step), ms."""
    d = [_card_s(s) for s in _named(ctx, "optim.apply_updates")
         if s["card"]]
    return 1e3 * sum(d) / len(d) if d else None


def head_loss_share(ctx: Dict) -> Optional[float]:
    return _card_share(ctx, ("lm.head_loss", "lm.head_loss.bwd"),
                       "train.step")


STEADY, SURGE = "split.qwen3-1.7b.steady", "split.granite-moe-1b-a400m.surge"
TRAIN = ("train.qwen3-1.7b.seq4k", "train.granite-moe-1b-a400m.seq4k")

# the per-layer numbers a span window gives, by the name a metric would
# take, with the cells whose window has something for it to read
READERS = {
    "stage_ms.serve": (stage_ms, (STEADY,)),
    "head_ms.serve": (head_ms, (STEADY,)),
    "engine_host_ms.serve": (engine_host_ms, (STEADY,)),
    "queue_wait_share.serve": (queue_wait_share, (STEADY,)),
    "moe_route_share.surge": (moe_route_share, (SURGE,)),
    "moe_experts_share.surge": (moe_experts_share, (SURGE,)),
    "moe_drop_share.surge": (moe_drop_share, (SURGE,)),
    "moe_dispatch_share.train": (moe_dispatch_share_train, TRAIN[1:]),
    "moe_combine_share.train": (moe_combine_share_train, TRAIN[1:]),
    "optimizer_ms.train": (optimizer_ms, TRAIN),
    "head_loss_share.train": (head_loss_share, TRAIN),
}


def readings(ctx: Dict, cell: str) -> Dict[str, Optional[float]]:
    """Every number of ``READERS`` that cell ``cell`` reads."""
    return {name: read(ctx) for name, (read, cells) in READERS.items()
            if cell in cells}
