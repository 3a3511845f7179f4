"""The op-stream recorder: eager torch's counterpart of a jaxpr (the port
of ``repro/analysis/jaxpr/jaxpr_util.py``; DESIGN.md §15).

A jaxpr is what XLA compiles; the port compiles nothing, so what it runs
*is* the stream of torch calls that one call of a program makes.
:class:`Recorder` records that stream under a
:class:`torch.overrides.TorchFunctionMode`: every torch function and
``Tensor`` method called while it is active (``torch.where``,
``Tensor.sum``, ``Tensor.__getitem__``, ``torch.tensor``, …), at the
port's own call, with

* the function's name;
* the shapes, dtypes and devices of its tensor inputs and outputs;
* its non-tensor arguments, abstracted (:func:`token`: a float's value is
  dropped, ints, bools, strings, dtypes and index structure are kept);
* its call site: the innermost frame in ``src/repro_torch/`` outside the
  helper modules ``core/fp.py``, ``rng.py`` and ``kernels/ops.py``, so
  that ``fsum``'s reduction reports at ``_compute_pass``, as the
  reference's jaxpr anchors a ``reduce_sum`` at its user frame;
* for the accumulating reductions (``SCOPED_OPS``, what J001 reads),
  which of the scope functions (``run_sim``, ``summarize``) it ran under.

Why a function mode and not ``TorchDispatchMode``: the dispatch mode
sees ATen ops after decomposition and autograd (``aten::index.Tensor``,
``aten::sum.dim_IntList``), far from the source line that called them and
without the Python-level arguments (``Tensor.__getitem__``'s index tuple,
``torch.tensor``'s host data) that J003 and J004 read.  The function mode
sees each call once, as written; nested torch calls made by a torch
function's own Python code are not re-recorded (the mode is off while its
handler runs).

The hand-written kernels launch through ctypes, which no mode sees; their
launch bookkeeping (``kernels/build.py``'s ``launched``) appends a
``kernel:<name>`` event to the active recorder, so the audited program is
the card's program.

Each recorder also computes what needs live tensors, as it records:

* **index provenance** (J003): outputs of ``clamp*`` / ``clip*`` are
  tagged *clipped*, and outputs of a ``where`` that sends some lanes to a
  constant (``where(ok, seq, cap)``) *redirected*; the tags follow the
  tensor through dtype casts and views; an index op (``__getitem__``
  / ``__setitem__`` with a tensor index, ``gather``, ``scatter*``,
  ``index_put*``, ``index_select``, ``index_add*``, ``take*``) whose index
  carries a tag is flagged;
* **host data** (J004): ``torch.tensor`` / ``as_tensor`` / ``asarray`` /
  ``from_numpy`` of host values, and on the card every copy from the host
  to the device (``Tensor.to`` / ``cuda`` / ``copy_``), flagged with their
  bytes.

Events are interned tuples (a simulator tick repeats the same ops), so a
recording of one run is a list of references to a few thousand distinct
events.
"""
from __future__ import annotations

import os
import sys
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode, resolve_name
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.kernels import build as _build

#: the port's tree marker in a frame's file name
PKG_MARKER = os.sep + "src" + os.sep + "repro_torch" + os.sep
#: helper modules whose ops report at their caller's line
HELPERS = tuple(os.sep.join(p.split("/")) for p in
                ("core/fp.py", "rng.py", "kernels/ops.py"))
#: the ops whose scope is recorded: the accumulating reductions J001
#: reads (walking the whole stack for every op would double the cost)
SCOPED_OPS = frozenset({"sum", "nansum", "mean", "nanmean", "prod",
                        "cumsum", "cumprod", "matmul", "__matmul__",
                        "__rmatmul__", "einsum", "bmm", "mm", "mv", "dot"})

# event flags
IN_RUN_SIM = 1
IN_SUMMARIZE = 2
IDX_CLIPPED = 4          # an index made by clamp* / clip*
IDX_REDIRECTED = 8       # an index redirected by where
HOST_DATA = 16           # a tensor made from host data, or a host->device copy

#: functions whose frames mark an event's scope (J001: inside the loop)
_SCOPE_BITS = {"run_sim": IN_RUN_SIM, "summarize": IN_SUMMARIZE}

_CLAMPS = {"clamp", "clamp_", "clamp_min", "clamp_min_", "clamp_max",
           "clamp_max_", "clip", "clip_"}
_REDIRECTS = {"where"}
#: ops whose output is their first argument's values, cast or viewed:
#: index provenance follows the tensor through them
_PASS_THROUGH = {"to", "long", "int", "short", "type", "view", "view_as",
                 "reshape", "reshape_as", "flatten", "unsqueeze", "squeeze",
                 "expand", "expand_as", "broadcast_to", "contiguous",
                 "clone", "detach", "t", "permute", "transpose", "movedim",
                 "__getitem__", "unflatten", "ravel"}
#: index ops: the argument position of their index (None: the index
#: tuple of __getitem__ / __setitem__ / index_put*)
_INDEX_OPS = {"__getitem__": None, "__setitem__": None, "index_put": None,
              "index_put_": None, "_index_put_impl_": None,
              "gather": 2, "scatter": 2, "scatter_": 2, "scatter_add": 2,
              "scatter_add_": 2, "scatter_reduce": 2, "scatter_reduce_": 2,
              "index_select": 2, "index_add": 2, "index_add_": 2,
              "index_copy": 2, "index_copy_": 2, "index_fill": 2,
              "index_fill_": 2, "take": 1, "take_along_dim": 1}
_HOST_FACTORIES = {"tensor", "as_tensor", "asarray", "from_numpy"}
_COPIES = {"to", "cuda", "copy_"}


class Site(NamedTuple):
    file: str        # repo-relative posix path
    line: int
    func: str


class Event(NamedTuple):
    """One recorded call.  ``ins`` / ``outs`` are ``(shape, dtype,
    device type)`` of the tensors in the arguments and the result, in
    order; ``args`` the abstracted non-tensor arguments (tensors as
    ``"T"``)."""
    name: str                 # "torch.where", "torch.Tensor.sum", "kernel:phi_update"
    site: Optional[Site]
    ins: Tuple
    outs: Tuple
    args: Tuple
    flags: int

    @property
    def op(self) -> str:
        """The bare op name: ``sum`` for ``torch.Tensor.sum``."""
        return self.name.rsplit(".", 1)[-1]


def token(x: Any) -> Any:
    """A hashable, value-abstracted token of a non-tensor argument: a
    float's value is data (``"f"``); ints, bools, strings, dtypes, devices
    (by type) and the structure of slices and sequences are kept."""
    tp = type(x)
    if tp is torch.Tensor or isinstance(x, torch.Tensor):
        return "T"
    if tp is float:
        return "f"
    if tp is int or tp is bool or x is None or tp is str:
        return x
    if tp is tuple or tp is list or isinstance(x, (tuple, list)):
        return tuple([token(v) for v in x])
    if tp is slice:
        return ("slice", token(x.start), token(x.stop), token(x.step))
    if x is Ellipsis:
        return "..."
    if isinstance(x, float):
        return "f"
    if isinstance(x, int):
        return int(x)
    if tp is torch.dtype:
        return str(x)
    if tp is torch.device:
        return x.type
    if isinstance(x, dict):
        return tuple(sorted((k, token(v)) for k, v in x.items()))
    shape, dtype = getattr(x, "shape", None), getattr(x, "dtype", None)
    if shape is not None and dtype is not None:      # a numpy array/scalar
        if shape == () and getattr(dtype, "kind", "") in "iub":
            return int(x)
        return ("nd", tuple(shape), str(dtype))
    return tp.__name__


_Tensor = torch.Tensor


def _tensors(x, out: list) -> list:
    """The tensors in a (nested) argument or result, in order."""
    if isinstance(x, _Tensor):
        out.append(x)
    elif isinstance(x, (tuple, list)):
        for v in x:
            if isinstance(v, _Tensor):
                out.append(v)
            elif isinstance(v, (tuple, list)):
                _tensors(v, out)
    return out


def _to_constant(args) -> bool:
    """``where(cond, x, c)`` with one branch a number (or a 0-dim tensor):
    a redirect of some lanes to a constant slot, the port's spelling of
    FILL_OR_DROP.  A ``where`` between two tensors is a masked update of
    state, not a redirect."""
    if len(args) != 3:
        return False
    return any(not isinstance(a, _Tensor) or a.dim() == 0
               for a in args[1:])


def _device(t: torch.Tensor) -> str:
    return "cuda" if t.is_cuda else ("meta" if t.is_meta else "cpu")


def tensor_bytes(sig: Tuple) -> int:
    shape, dtype, _ = sig
    n = 1
    for d in shape:
        n *= d
    return n * dtype.itemsize


class Recording:
    """One program's recorded op stream (see the module docstring)."""

    def __init__(self, events: List[Event]):
        self.events = events
        self._unique: Optional[List[Event]] = None

    def __len__(self) -> int:
        return len(self.events)

    def unique(self) -> List[Event]:
        """The distinct events, in first-seen order (events are interned,
        so identity is equality)."""
        if self._unique is None:
            self._unique = list({id(e): e for e in self.events}.values())
        return self._unique

    def kernels(self) -> Dict[str, int]:
        """Launches of each hand-written kernel in the stream."""
        out: Dict[str, int] = {}
        for ev in self.events:
            if ev.name.startswith("kernel:"):
                out[ev.name[7:]] = out.get(ev.name[7:], 0) + 1
        return out


_ACTIVE: List["Recorder"] = []

# what each op does for the recorder (bits of _KIND)
_K_CLAMP, _K_REDIRECT, _K_PASS, _K_INDEX, _K_HOST, _K_COPY = (
    1, 2, 4, 8, 16, 32)


def _kind(op: str) -> int:
    return ((_K_CLAMP if op in _CLAMPS else 0)
            | (_K_REDIRECT if op in _REDIRECTS else 0)
            | (_K_PASS if op in _PASS_THROUGH else 0)
            | (_K_INDEX if op in _INDEX_OPS else 0)
            | (_K_HOST if op in _HOST_FACTORIES else 0)
            | (_K_COPY if op in _COPIES else 0))


# func -> (name, op, kind), or None for attribute reads (Tensor.shape …),
# which are not ops; shared by every recorder (pure functions of func)
_FUNCS: Dict[Any, Optional[Tuple[str, str, int]]] = {}
# id(code) -> (repo-relative file or None, is a helper, scope bit, code);
# keyed by id because hashing a code object hashes its bytecode
_CODES: Dict[int, Tuple] = {}


def _func_info(func) -> Optional[Tuple[str, str, int]]:
    name = resolve_name(func) or getattr(func, "__qualname__",
                                         getattr(func, "__name__",
                                                 repr(func)))
    if name.endswith("__get__"):
        info = None
    else:
        op = name.rsplit(".", 1)[-1]
        info = (name, op, _kind(op))
    try:
        _FUNCS[func] = info
    except TypeError:                            # an unhashable callable
        pass
    return info


def _code_info(code) -> Tuple:
    fn = code.co_filename
    rel = None
    if PKG_MARKER in fn:
        rel = ("src/repro_torch/"
               + fn.split(PKG_MARKER, 1)[1].replace(os.sep, "/"))
    helper = fn.endswith(HELPERS) and rel is not None
    info = (rel, helper, _SCOPE_BITS.get(code.co_name, 0), code)
    _CODES[id(code)] = info
    return info


def _kernel_launched(name: str) -> None:
    if _ACTIVE:
        _ACTIVE[-1].kernel(name)


class Recorder(TorchFunctionMode):
    """``with Recorder() as rec: fn(*args)`` records ``fn``'s op stream;
    ``rec.recording()`` returns it.  ``full=False`` records only what
    J002 compares (name, site, output dtypes, flags): the float64 pass."""

    def __init__(self, full: bool = True):
        super().__init__()
        self.full = full
        self._events: List[Event] = []
        self._intern: Dict[Tuple, Event] = {}
        self._tags = WeakIdKeyDictionary()
        self._stop = None

    # -- context ----------------------------------------------------------

    def __enter__(self):
        self._stop = sys._getframe(1)
        _ACTIVE.append(self)
        if _kernel_launched not in _build.LAUNCH_OBSERVERS:
            _build.LAUNCH_OBSERVERS.append(_kernel_launched)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        if not _ACTIVE:
            _build.LAUNCH_OBSERVERS.remove(_kernel_launched)
        self._stop = None
        return super().__exit__(*exc)

    def recording(self) -> Recording:
        return Recording(self._events)

    # -- frames -------------------------------------------------------------

    def _site(self, depth: int) -> Optional[Tuple]:
        """The call site ``(file, line, function)`` of the current torch
        call, walking up from ``depth`` frames above this one (2: the
        caller of ``__torch_function__``)."""
        f = sys._getframe(depth)
        stop, codes = self._stop, _CODES
        while f is not None and f is not stop:
            code = f.f_code
            info = codes.get(id(code))
            if info is None or info[3] is not code:
                info = _code_info(code)
            if info[0] is not None and not info[1]:
                return (info[0], f.f_lineno, code.co_name)
            f = f.f_back
        return None

    def _scope(self, depth: int) -> int:
        """The scope bits (``IN_RUN_SIM`` …) of the current torch call:
        which scope functions are on the stack below it."""
        f = sys._getframe(depth)
        bits, stop, codes = 0, self._stop, _CODES
        while f is not None and f is not stop:
            code = f.f_code
            info = codes.get(id(code))
            if info is None or info[3] is not code:
                info = _code_info(code)
            bits |= info[2]
            f = f.f_back
        return bits

    def _append(self, key: Tuple) -> None:
        ev = self._intern.get(key)
        if ev is None:
            name, site, *rest = key
            ev = self._intern[key] = Event(
                name, Site(*site) if site is not None else None, *rest)
        self._events.append(ev)

    def kernel(self, name: str) -> None:
        """A hand-written kernel's launch (from ``kernels/build.py``),
        sited at its wrapper's caller (above the observer, ``launched``,
        the wrapper and, as a helper, ``kernels/ops.py``)."""
        self._append(("kernel:" + name, self._site(5), (), (), (),
                      self._scope(5)))

    # -- the mode -----------------------------------------------------------

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        try:
            info = _FUNCS[func]
        except KeyError:
            info = _func_info(func)
        except TypeError:
            info = _func_info(func)
        if info is None:
            return out
        name, op, kind = info
        site = self._site(2)
        flags = self._scope(2) if op in SCOPED_OPS else 0
        outs = ([out] if isinstance(out, _Tensor) else _tensors(out, []))
        if kind or self.full:
            ins = _tensors(args, [])
            if kwargs:
                _tensors(list(kwargs.values()), ins)
            if kind:
                flags |= self._track(op, kind, args, kwargs, ins, outs)
        if not self.full:
            self._append((name, site, (), tuple([t.dtype for t in outs]),
                          (), flags))
            return out
        targs = tuple([token(a) for a in args])
        if kwargs:
            targs += tuple(sorted((k, token(v)) for k, v in kwargs.items()))
        self._append((name, site,
                      tuple([(t.shape, t.dtype, _device(t)) for t in ins]),
                      tuple([(t.shape, t.dtype, _device(t)) for t in outs]),
                      targs, flags))
        return out

    def _track(self, op, kind, args, kwargs, ins, outs) -> int:
        """Index provenance (J003) and host data (J004) of one call; its
        flags."""
        flags, tags = 0, self._tags
        if kind & _K_CLAMP or (kind & _K_REDIRECT and _to_constant(args)):
            tag = IDX_CLIPPED if kind & _K_CLAMP else IDX_REDIRECTED
            for t in outs:
                tags[t] = tag
        elif kind & _K_PASS and ins and outs and ins[0] in tags:
            if op != "__getitem__" or len(ins) == 1:
                tags[outs[0]] = tags[ins[0]]
        if kind & _K_INDEX:
            pos = _INDEX_OPS[op]
            if pos is None:
                idx = args[1] if len(args) > 1 else kwargs.get("indices")
            else:
                idx = (args[pos] if len(args) > pos
                       else kwargs.get("index", kwargs.get("indices")))
            for t in _tensors(idx, []):
                flags |= tags.get(t, 0)
        if kind & _K_HOST and not (args and isinstance(args[0], _Tensor)):
            flags |= HOST_DATA
        elif kind & _K_COPY and ins and outs:
            src, dst = (ins[-1], ins[0]) if op == "copy_" else (ins[0],
                                                                  outs[0])
            if not (src.is_cuda or src.is_meta) and dst.is_cuda:
                flags |= HOST_DATA
        return flags
