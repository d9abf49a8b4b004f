"""An in-memory tracer of the port's own spans, off by default.

    from cgd_tpu_torch.utils import tracing

    tracing.enable()
    for _ in clip_guided_diffusion(...):
        pass
    spans = tracing.take()  # the finished spans, oldest first; the list is cleared

``span(name, **counts)`` is a context manager. With tracing off it returns
one shared object that does nothing: one global check, no clock read, no
allocation. With tracing on, a span records its name, ``start_ns`` and
``end_ns`` from ``time.time_ns()`` (Unix-epoch nanoseconds: the clock of
``torch.profiler``'s kineto events, so a span can be laid over a device
trace without a second clock), the id of its parent (the innermost span open
on the same thread when it began), the id of its request and its counts
(numbers, or a short string such as a model's name). ``request(name,
**counts)`` opens a span that starts a new request: every span opened inside
it shares its request id, which the spans outside any request leave None.

The parent stack is per thread. A generator that yields from inside a span
hands it back with ``detached(span)`` around the ``yield``: the caller's own
spans do not nest under it while it is suspended, and the span is the
innermost again on whichever thread resumes it.

``enable()``, ``disable()`` and ``take()`` are the only switch; whoever
enables the tracer takes the spans and writes them out
(``add_to_chrome_trace`` puts them into a ``torch.profiler`` trace on its
clock; ``tools/span_report.py`` reduces them).

The spans the port opens, named ``layer.what``:

    api.request      one clip_guided_diffusion call, from entry to return
                     (batch, steps); the time its caller holds it suspended
                     at a yield lies in no child span
    api.models       the CLIP and UNet resolved, cast (and replicated over a
                     mesh); hits, misses: the models served from the
                     weights' model cache and those loaded
    weights.read     the converted cache read (model, bytes: the file's size)
    weights.build    a module built (on the host for a checkpoint, on the
                     run's device with its random init for random weights)
    weights.load     the flat parameters loaded into the host module
    weights.to_device  the module moved to the run's device
    api.prompts      the prompt encoding (prompts)
    loop.segment     one sample_loop segment, its sinks included (first,
                     steps)
    step             one guided-step call (k, guided, cutn; graph: 1 where
                     the call replays the step's CUDA graph, 0 where it runs
                     eagerly); the phases below open inside an eager step
                     and inside a capture, not under a replay, where the
                     host does none of their work
    step.capture     inside a step: its CUDA graph captured (guided, cutn)
    step.unet        the model forward with p_mean_variance
    step.guidance    the guidance loss: cutouts, CLIP, the losses
    guidance.clip    inside step.guidance: the CLIP image tower's forward
                     over the cutouts, split over a mesh's devices where
                     there is one (tower: "resnet" or "vit", images: cutouts
                     times batch, resolution: the tower's input side)
    step.backward    torch.autograd.grad of the loss
    step.update      the gradient transform, the noise draw and the update
                     (ancestral: 1 for the ancestral update, 0 for DDIM and
                     DPM-Solver)
    images.to_host   a save point's prediction copied to the host (waits for
                     the device's queued work)
    images.write     one log_image: the PNG encode and its writes (k,
                     bytes written), or the hand-off to the frame writer
                     under async_frames (k, queued: the frame's bytes)
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from typing import Dict, List

_on = False
_done: List["Span"] = []
_ids = itertools.count(1)
_requests = itertools.count(1)
_local = threading.local()


def _stack() -> List["Span"]:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class Span:
    """One recorded interval of the port's work."""

    __slots__ = ("name", "id", "parent", "request", "thread", "start_ns", "end_ns", "counts",
                 "_new_request")

    def __init__(self, name: str, counts: Dict, new_request: bool = False):
        self.name, self.counts, self._new_request = name, counts, new_request
        self.id = next(_ids)
        self.start_ns = self.end_ns = None

    def __enter__(self) -> "Span":
        st = _stack()
        top = st[-1] if st else None
        self.parent = top.id if top is not None else None
        self.request = next(_requests) if self._new_request else (
            top.request if top is not None else None)
        self.thread = threading.get_ident()
        st.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        st = _stack()
        if self in st:  # not there when a generator's span is closed from another thread
            st.remove(self)
        _done.append(self)
        return False

    def note(self, **counts) -> None:
        """Adds counts known only once the span is open."""
        self.counts.update(counts)

    def as_dict(self) -> Dict:
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "request": self.request, "thread": self.thread, "start_ns": self.start_ns,
                "end_ns": self.end_ns, "counts": dict(self.counts)}


class _NoSpan:
    """What ``span`` returns with tracing off: enters, exits, notes nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def note(self, **counts) -> None:
        pass


NO_SPAN = _NoSpan()


def span(name: str, **counts):
    """A context manager recording ``name`` with ``counts``; ``NO_SPAN``
    with tracing off."""
    if not _on:
        return NO_SPAN
    return Span(name, counts)


def request(name: str, **counts):
    """``span``, starting a new request id."""
    if not _on:
        return NO_SPAN
    return Span(name, counts, new_request=True)


@contextlib.contextmanager
def detached(sp):
    """Takes the open span ``sp`` (and any span above it) off this thread's
    stack for the body, and puts them back on the stack of the thread that
    leaves the body: a generator's ``yield`` from inside ``sp``."""
    if sp is NO_SPAN:
        yield
        return
    st = _stack()
    above = st[st.index(sp):] if sp in st else []
    del st[len(st) - len(above):]
    try:
        yield
    finally:
        _stack().extend(above)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def take() -> List[Span]:
    """The spans finished since the last ``take()``, oldest end first; clears
    them. Spans still open are not among them."""
    global _done
    out, _done = _done, []
    return out


CHROME_PID = "cgd_tpu_torch spans"


def chrome_events(spans, base_ns: int) -> List[Dict]:
    """The spans as Chrome-trace complete events ("ph": "X") on a row of
    their own (``CHROME_PID``; one ``tid`` per thread), ``ts`` and ``dur``
    in µs from ``base_ns``: a ``torch.profiler`` trace's
    ``baseTimeNanoseconds`` puts them on that trace's clock."""
    events = [{"ph": "M", "name": "process_name", "pid": CHROME_PID, "tid": 0,
               "args": {"name": CHROME_PID}}]
    for s in spans:
        d = s.as_dict()
        events.append({
            "ph": "X", "cat": "cgd_span", "name": d["name"], "pid": CHROME_PID,
            "tid": d["thread"],
            "ts": (d["start_ns"] - base_ns) / 1e3, "dur": (d["end_ns"] - d["start_ns"]) / 1e3,
            "args": {"id": d["id"], "parent": d["parent"], "request": d["request"],
                     **d["counts"]}})
    return events


def add_to_chrome_trace(path, spans) -> None:
    """Adds the spans to the Chrome trace that ``torch.profiler`` exported
    to ``path``, on its clock (its ``baseTimeNanoseconds``; a trace without
    one counts from the epoch)."""
    with open(path) as f:
        trace = json.load(f)
    trace["traceEvents"].extend(chrome_events(spans, int(trace.get("baseTimeNanoseconds", 0))))
    with open(path, "w") as f:
        json.dump(trace, f)
