"""Timing spans and device counters inside the port, off by default.

The layers the benchmark's cells run open named spans (the split engine's
epoch, stages, head and queues; the MoE block's routing, dispatch,
experts and combine; the LM head and its loss; AdamW; the train step) and
add counters (the MoE block's assignments and capacity drops).  While
tracing is off, which is the default, each call costs a flag test:

* ``span(name, ...)`` returns one shared no-op context object;
* ``grad_mark(name, x)`` returns ``x`` itself;
* ``count(name, value)`` and ``end(rec, at)`` return at once, ``begin``
  returns ``None``.

``enable()`` turns tracing on, ``disable()`` off, and ``collect()`` hands
back what was recorded and clears it.  While on:

* **Spans.**  A span records its name, its attrs (``stage``,
  ``request``), its parent (the innermost span open on the same thread:
  autograd runs a backward pass on a thread of its own) and its interval
  on the host's ``time.perf_counter_ns``.  ``span`` is a context manager;
  ``begin`` / ``end`` bracket an interval that is not a block of code (a
  request's wait in a queue), and ``end`` reads no clock: the interval
  ends where a span beside it opens or closes.
* **Card intervals.**  A span opened with ``device=True`` (or with a CUDA
  tensor as ``device``) also records a CUDA event at each end, taken from
  a pool that ``enable()`` fills ahead; on the CPU its card interval is
  its host interval.  A meta
  tensor as ``device`` records nothing (the dry-run's shapes).
* **Profiler ranges.**  While a ``torch.profiler`` runs, every span also
  opens ``record_function(name)``, so the profiler's trace carries it.
* **Backward.**  ``grad_mark`` puts an identity ``autograd.Function`` at a
  region's input (``end=False``) and output (``end=True``).  In the
  backward pass the output's mark opens ``<name>.bwd`` and the input's
  mark closes it, each with a CUDA event: the region's backward time on
  the card.
* **Counters** add on the device: one 0-d int64 tensor a name, with no
  ``.item()`` and no wait for the card (Python ints add on the host).

``collect()`` is the only call that waits for the card.  It puts every
event on the host's ``perf_counter`` clock by two origin pairs, the one
taken at ``enable()`` (or at the last ``collect()``) and one taken now:
an event recorded on the idle card, and the host's clock halfway between
a read just before the record and one just after the card has run it.
An event's host time is interpolated between the two pairs, which takes
out the drift of the card's clock against the host's over the window.
The host and card intervals of every span then lie on one clock, to
within the larger half-width of the two origins' brackets (``collect``
returns it as ``clock_error_s``: about 6 µs on an H100 host, where the
card's clock drifted from the host's by 5 to 6 parts in a million, 40 to
55 µs over 8 to 10 s, which one origin alone would have left in).  Each
host read comes just before its event's record, so a card time lies no
earlier than its host time but by that bound.  It returns plain
lists and numbers, and folds the counters into a ``Registry`` as
``Counter``s where given one (``obs.prom`` exposes them).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import torch

from repro_torch.obs.registry import Registry

# a span's card interval: none, its host interval (the CPU's), or events
_NONE, _HOST, _EVENTS = 0, 1, 2

_ON = False
_CUDA = False                       # card intervals from CUDA events
_origin = None                      # (host ns, event, error ns): the last
                                    # _take_origin()
_done: List["_Rec"] = []            # closed spans, in the order they closed
_host_counts: Dict[str, int] = {}
_dev_counts: Dict[str, torch.Tensor] = {}
_pool: List = []                    # CUDA events free for reuse
# events created ahead at enable(): an event's first record creates it,
# which costs the host about as much again as the record itself (a split
# serve step of granite-moe opens about 65 spans, most with card events)
_PREFILL = 8192
_streams: Dict = {}                 # CUDA streams by (id, device, type)
_local = threading.local()          # .stack: the spans open on a thread
_lock = threading.Lock()            # the counters (forward and backward
                                    # passes run on two threads)


class _Rec:
    """A span: its own context manager (``span``), or opened by ``begin``
    and closed by ``end``, or by a backward mark."""
    __slots__ = ("name", "stage", "request", "parent", "thread", "dev",
                 "after", "rf", "t0", "t1", "e0", "e1")

    def __init__(self, name, dev, stage, request, after=None):
        self.name, self.dev, self.after = name, dev, after
        self.stage, self.request = stage, request
        self.parent = self.rf = self.t0 = self.t1 = self.e0 = self.e1 = None

    def open(self, push: bool = True):
        stack = _stack()
        if push:
            self.parent = stack[-1] if stack else None
            stack.append(self)
        self.thread = threading.get_ident()
        self.t0 = time.perf_counter_ns()
        if self.dev == _EVENTS:
            prev = self.after
            self.e0 = prev.e1 if prev is not None and prev.e1 is not None \
                else _event()
        return self

    def close(self):
        # each host read comes before its event's record, so that a card
        # time never lies before its host time but by the clock's error
        self.t1 = time.perf_counter_ns()
        if self.dev == _EVENTS:
            self.e1 = _event()
        _pop(self)
        _done.append(self)

    def __enter__(self):
        if torch._C._autograd._profiler_enabled():
            self.rf = torch.autograd.profiler.record_function(self.name)
            self.rf.__enter__()
        return self.open()

    def __exit__(self, *exc):
        self.close()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class _Off:
    """The span returned while tracing is off (and for meta tensors)."""
    __slots__ = ()
    dev, e1, t0, t1 = _NONE, None, None, None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


def enabled() -> bool:
    return _ON


def enable() -> None:
    """Turn tracing on.  Where CUDA is there, this fills the pool with
    ``_PREFILL`` events, each recorded once, and where no origin pair is
    held (from an earlier ``enable`` or ``collect``) waits for the card
    once and takes one on it, idle."""
    global _ON, _CUDA, _origin
    if _ON:
        return
    _CUDA = torch.cuda.is_available()
    if _CUDA:
        stream = _stream()
        for _ in range(_PREFILL - len(_pool)):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(stream)
            _pool.append(ev)
        if _origin is None:
            _origin = _take_origin()
    _ON = True


def _take_origin():
    """(host ns, event, error ns): an event recorded on the idle card, and
    the host's clock halfway between a read just before the record and
    one just after the card has run it, to within ``error`` (half the
    bracket); the narrowest bracket of five."""
    torch.cuda.synchronize()
    stream = _stream()
    best = None
    for _ in range(5):
        ev = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter_ns()
        ev.record(stream)
        ev.synchronize()
        t1 = time.perf_counter_ns()
        if best is None or t1 - t0 < 2 * best[2]:
            best = ((t0 + t1) // 2, ev, (t1 - t0) // 2)
    return best


def disable() -> None:
    """Turn tracing off; what was recorded waits for ``collect()``."""
    global _ON
    _ON = False


def _card(device) -> Optional[int]:
    """How a span opened with ``device`` times the card; None where it
    records nothing (a meta tensor)."""
    if isinstance(device, torch.Tensor):
        if device.is_meta:
            return None
        return _EVENTS if device.is_cuda and _CUDA else _HOST
    if not device:
        return _NONE
    return _EVENTS if _CUDA else _HOST


def span(name: str, device=False, *, after=None, stage=None, request=None):
    """A context manager timing its block as ``name``.  ``device``: True,
    or a tensor on the card, for a card interval too; a meta tensor for
    none at all.  ``after``: the span that closed just before this one
    opens, nothing launched between; its card end is this span's card
    start (one CUDA event fewer)."""
    if not _ON:
        return OFF
    dev = _card(device)
    if dev is None:
        return OFF
    return _Rec(name, dev, stage, request, after)


def begin(name: str, *, stage=None, request=None):
    """Open a host interval that is not a block of code (so it has no
    parent); ``end`` closes it.  Returns ``None`` while tracing is off."""
    if not _ON:
        return None
    return _Rec(name, _NONE, stage, request).open(push=False)


def end(rec, at) -> None:
    """Close ``begin``'s ``rec`` at the span ``at``, reading no clock: where
    ``at`` is still open, where it opened (a wait in a queue ends as its
    stage starts); where ``at`` has closed, where it closed, on the host
    and, if ``at`` has a card interval, on the card (a request ends with
    its head's card end; its card interval runs from its host start)."""
    if rec is None or at.t0 is None:
        return
    if at.t1 is None:
        rec.t1 = at.t0
    else:
        rec.t1 = at.t1
        if at.dev:
            rec.dev, rec.e1 = at.dev, at.e1
    _done.append(rec)


def count(name: str, value) -> None:
    """Add ``value`` (an int, or a 0-d integer tensor, added on its device
    without a wait) to the counter ``name``."""
    if not _ON:
        return
    if not isinstance(value, torch.Tensor):
        with _lock:
            _host_counts[name] = _host_counts.get(name, 0) + int(value)
        return
    if value.is_meta:
        return
    acc = _dev_counts.get(name)
    if acc is None:
        # a normal tensor (not an inference one), so that it adds in and
        # out of inference mode
        with _lock, torch.inference_mode(False):
            acc = _dev_counts.setdefault(name, torch.zeros(
                (), dtype=torch.int64, device=value.device))
    acc.add_(value)


def grad_mark(name: str, x: torch.Tensor, end: bool = False
              ) -> torch.Tensor:
    """``x`` through an identity whose backward opens (``end=True``, at a
    region's output) or closes (at its input) the span ``<name>.bwd``;
    ``x`` itself while tracing is off, grad is off or ``x`` needs none."""
    if not _ON or not torch.is_grad_enabled() or not x.requires_grad \
            or x.is_meta:
        return x
    return _Mark.apply(x, name + ".bwd", end)


class _Mark(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, name, opens):
        ctx.name, ctx.opens, ctx.dev = name, opens, _card(x)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if _ON:
            if ctx.opens:
                _Rec(ctx.name, ctx.dev, None, None).open()
            else:
                _close_bwd(ctx.name)
        return g, None, None


def _close_bwd(name: str) -> None:
    for rec in reversed(_stack()):
        if rec.name == name:
            rec.close()
            return


def _stack() -> List[_Rec]:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


def _pop(rec: _Rec) -> None:
    stack = _stack()
    if stack and stack[-1] is rec:
        stack.pop()
    elif rec in stack:
        stack.remove(rec)


def _stream():
    """The current CUDA stream, its object cached by the stream's id:
    ``torch.cuda.current_stream()`` builds a new one each call, which
    costs the host about twice the event's record."""
    key = torch._C._cuda_getCurrentStream(torch._C._cuda_getDevice())
    stream = _streams.get(key)
    if stream is None:
        stream = _streams[key] = torch.cuda.Stream(
            stream_id=key[0], device_index=key[1], device_type=key[2])
    return stream


def _event():
    """A CUDA event from the pool, recorded on the current stream."""
    ev = _pool.pop() if _pool else torch.cuda.Event(enable_timing=True)
    ev.record(_stream())
    return ev


def collect(registry: Optional[Registry] = None) -> Dict:
    """Everything recorded since the last call, and clear it: ``{"spans":
    [...], "counters": {name: int}, "clock_error_s": float}``.  A span is a
    dict of its ``name``, ``attrs``, ``parent`` (an index into the list, or
    None), ``thread``, ``host`` and ``card`` intervals (``[start, end]`` in
    seconds of ``time.perf_counter``; ``card`` None for a host span).
    Spans still open are left out.  ``clock_error_s`` bounds how far a card
    time may lie from the host's clock (0 without CUDA).  Waits for the
    card (the only call that does)."""
    global _done, _host_counts, _dev_counts, _origin
    with _lock:
        done, host, dev = _done, _host_counts, _dev_counts
        _done, _host_counts, _dev_counts = [], {}, {}
    error_ns, at = 0, None
    if _CUDA and _origin is not None:
        (h0, ev0, err0), (h1, ev1, err1) = _origin, _take_origin()
        _origin, error_ns = (h1, ev1, err1), max(err0, err1)
        card_ms = ev0.elapsed_time(ev1)
        scale = (h1 - h0) * 1e-6 / card_ms if card_ms > 0 else 1.0

        def at(ev):
            return (h0 * 1e-6 + ev0.elapsed_time(ev) * scale) * 1e-3

    index = {id(r): i for i, r in enumerate(done)}
    used = {}
    out = []
    for r in done:
        t0, t1 = r.t0 * 1e-9, r.t1 * 1e-9
        card = None
        if r.dev:
            card = [t0, t1]
            for j, ev in enumerate((r.e0, r.e1)):
                if ev is not None:
                    used[id(ev)] = ev
                    card[j] = at(ev)
        out.append({"name": r.name,
                    "attrs": {k: getattr(r, k) for k in ("stage", "request")
                              if getattr(r, k) is not None},
                    "parent": index.get(id(r.parent)),
                    "thread": r.thread, "host": [t0, t1], "card": card})
    _pool.extend(used.values())
    counters = dict(host)
    for name, acc in dev.items():
        counters[name] = counters.get(name, 0) + int(acc)
    if registry is not None:
        for name, v in counters.items():
            registry.counter(name.replace(".", "_"),
                             help=f"{name}, from repro_torch.obs.spans"
                             ).inc(v)
    return {"spans": out, "counters": counters,
            "clock_error_s": error_ns * 1e-9}
