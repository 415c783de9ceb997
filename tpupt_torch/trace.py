"""Spans of the program's work on the host's clock, and the card's own stamps on the same clock.

A span names a piece of host work (``render.wait``, ``scene.compile``, ...): its start and
end (``time.perf_counter_ns()``), its id, its parent's id, and the id of the API call it
belongs to (the outermost span open when it started: every span of one ``render_image`` or
``render_film_grads`` call shares the id of that call's ``render`` or ``grads`` span).
Spans are kept in memory while ``recording()`` is on and exported only at the end
(``Recording.chrome_events``; ``render_image(profile_dir=...)`` merges them into its trace).

With recording off, ``span()`` is one check of a module-level value that returns a shared
null context: no clock is read and nothing is kept. Nothing turns recording on but
``recording()``: no environment variable, no argument of a render. A recording nests the spans
of the thread that opens them, as the program's calls run: on one thread.

The card's intervals. The CUDA graphs of a launch and of the gradient pass write the card's
clock (``%globaltimer``, ns) into device buffers at fixed points (``csrc/loop_cond.cu``,
``tpupt_loop_graph_add_stamp``); the launch's one host read brings them back, whether or
not a recording is on. With a recording on, ``card()`` places such an interval on the host's
clock, with the offset measured at ``recording()``'s start, as a span of the "card" track
whose parent is the host span that waited for it.

Spans are never emitted as ``torch.profiler.record_function`` ranges or NVTX ranges: Kineto
turns the former into CUDA-typed events, which a reader of the profiler's device activity
would count as device work.
"""

from __future__ import annotations

import contextlib
import json
import time

_rec = None  # the Recording in progress, or None


class Span:
    """One span: ids, name, start and end in perf_counter ns, attrs, and its track ("host",
    or "card" for an interval of the card's stamps placed on the host's clock)."""

    __slots__ = ("id", "parent", "call", "name", "start", "end", "attrs", "track")

    def __init__(self, id, parent, call, name, start, end, attrs, track="host"):
        self.id, self.parent, self.call, self.name = id, parent, call, name
        self.start, self.end, self.attrs, self.track = start, end, attrs, track

    @property
    def ns(self) -> int:
        return self.end - self.start

    def __repr__(self):
        return f"Span({self.name!r}, id={self.id}, parent={self.parent}, call={self.call}, {self.ns} ns)"


class _Opening:
    """The context manager of one span while a recording is on; enters as the Span."""

    __slots__ = ("rec", "name", "attrs", "span")

    def __init__(self, rec, name, attrs):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self) -> Span:
        rec = self.rec
        up = rec.stack[-1] if rec.stack else None
        sid = len(rec.spans)
        sp = self.span = Span(sid, None if up is None else up.id, sid if up is None else up.call, self.name,
                              0, 0, self.attrs)
        rec.spans.append(sp)
        rec.stack.append(sp)
        sp.start = time.perf_counter_ns()
        return sp

    def __exit__(self, *exc):
        self.span.end = time.perf_counter_ns()
        self.rec.stack.pop()
        return False


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def span(name: str, **attrs):
    """A span named `name` around a with-block, which it enters as the Span (attrs may be
    added to ``.attrs`` before it closes); with recording off, a shared null context that
    enters as None."""
    rec = _rec
    if rec is None:
        return _NULL
    return _Opening(rec, name, attrs)


def current() -> Span | None:
    """The innermost open span, or None (recording off, or no span open)."""
    rec = _rec
    return rec.stack[-1] if rec is not None and rec.stack else None


def card(parent: Span | None, name: str, t0: int, t1: int, **attrs) -> None:
    """An interval of the card's clock, [t0, t1] ns of ``%globaltimer``, as a span of the card
    track under `parent` (the host span that waited for it). Nothing without a recording,
    a parent or a calibrated clock."""
    rec = _rec
    if rec is None or parent is None or rec.clock is None:
        return
    off = rec.clock[0]
    rec.spans.append(Span(len(rec.spans), parent.id, parent.call, name, t0 - off, t1 - off, attrs, "card"))


class Recording:
    """The spans of one ``recording()``, in the order they opened.

    perf0, unix0: one (perf_counter_ns, time_ns) pair read at the start, which places spans
    in Unix ns (as torch.profiler's Kineto trace places its events). clock: (offset, error)
    in ns of the card's ``%globaltimer`` against perf_counter_ns (host = card - offset; the
    card's intervals lie within +-error of their place), None without a card.
    """

    def __init__(self):
        self.spans: list[Span] = []
        self.stack: list[Span] = []
        self.clock: tuple[int, int] | None = None
        self.perf0, self.unix0 = time.perf_counter_ns(), time.time_ns()

    def named(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]

    def children(self, sp: Span, track: str = "host") -> list[Span]:
        return [s for s in self.spans if s.parent == sp.id and s.track == track]

    def self_ns(self, sp: Span) -> int:
        """sp's duration less its host children's: the time no child span covers."""
        return sp.ns - sum(c.ns for c in self.children(sp))

    def unix_ns(self, t: int) -> int:
        return t - self.perf0 + self.unix0

    def chrome_events(self, base_ns: int = 0) -> list[dict]:
        """The spans as Chrome trace events ("X"), in us from `base_ns` (Unix ns; a Kineto
        trace's ``baseTimeNanoseconds``), under the process "tpupt_torch": host spans on the
        thread "spans", the card's intervals on "card"."""
        out = []
        for s in self.spans:
            if s.end < s.start:
                continue  # still open
            args = {"id": s.id, "parent": s.parent, "call": s.call, **s.attrs}
            out.append({"ph": "X", "cat": "tpupt_torch", "name": s.name, "pid": "tpupt_torch",
                        "tid": "spans" if s.track == "host" else "card",
                        "ts": (self.unix_ns(s.start) - base_ns) / 1e3, "dur": s.ns / 1e3, "args": args})
        return out


def _calibrate(tries: int = 5) -> tuple[int, int]:
    """(offset, error) of the current card's ``%globaltimer`` against perf_counter_ns: the stamp
    kernel launched alone `tries` times, each run bracketed by host clock reads around its
    launch and a synchronise; the tightest bracket is kept and its half-width is the error."""
    import torch

    from .ops import loop_cond

    lib = loop_cond.lib()
    buf = torch.zeros(tries, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    torch.cuda.synchronize()
    brackets = []
    for i in range(tries):
        t0 = time.perf_counter_ns()
        loop_cond.check(lib.tpupt_stamp(buf.data_ptr(), i, stream), "trace: the clock's stamp")
        torch.cuda.synchronize()
        brackets.append((t0, time.perf_counter_ns()))
    stamps = buf.tolist()
    (t0, t1), g = min(zip(brackets, stamps), key=lambda b: b[0][1] - b[0][0])
    return g - (t0 + t1) // 2, (t1 - t0 + 1) // 2


def active() -> Recording | None:
    """The recording in progress, or None."""
    return _rec


@contextlib.contextmanager
def recording():
    """Record spans within the block -> the Recording. With a CUDA card, the card's clock is
    calibrated against the host's at the start. Recordings do not nest."""
    global _rec
    if _rec is not None:
        raise RuntimeError("trace.recording: a recording is already on")
    rec = _rec = Recording()
    try:
        import torch

        if torch.cuda.is_available():
            rec.clock = _calibrate()
        yield rec
    finally:
        _rec = None


def merge_chrome_trace(path: str, rec: Recording) -> None:
    """Add the recording's spans and card intervals to the Chrome trace at `path` (written by
    torch.profiler), on its time base."""
    with open(path) as f:
        data = json.load(f)
    data.setdefault("traceEvents", []).extend(rec.chrome_events(int(data.get("baseTimeNanoseconds", 0))))
    if rec.clock is not None:
        data["tpupt_torch_clock"] = {"offset_ns": rec.clock[0], "error_ns": rec.clock[1]}
    with open(path, "w") as f:
        json.dump(data, f)
