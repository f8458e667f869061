"""Spans and counters at the program's layer boundaries, recorded only for
calls made while torch.profiler records.

A call to an entry point (align_from_pcm, align, align_batch_from_pcm:
`entry`) is recorded when the thread that enters it has a torch.profiler
recording (torch.autograd._profiler_enabled()); there is no setting. The
entry makes a request (a fresh id) that lives in a thread-local. Work
handed to another thread takes a child request (`fork`: a pair of a batch
gets its own id, with the batch's as parent), or the request itself
(`current`: a helper thread of one alignment), which that thread installs
for the work's duration (`installed`).

span(name) keeps (id, name, request, parent span, thread, t0_ns, t1_ns),
the parent being the span open on the same thread. The times come from
time.time_ns(), the profiler's clock: an exported chrome trace's `ts` is
time_ns / 1000 less its baseTimeNanoseconds / 1000. On a thread where the
profiler records, a span also opens record_function('describealign:' +
name), so the exported trace shows the program's layers beside the
kernels (the profiler records no record_function of another thread, so
the pool threads' spans are in the ring alone). count(name) adds to the
current request's counters. Outside a recorded call a span is one shared
no-op, and span() and count() cost one thread-local read.

To record spans, run an entry under torch.profiler.profile(...), then read
snapshot() (or the exported trace); clear() empties the records. They go
into a ring of RING_SPANS spans that drops the oldest past its bound and
counts them.
"""
import collections
import contextlib
import functools
import itertools
import threading
import time

import torch

PREFIX = 'describealign:'
RING_SPANS = 65536

Span = collections.namedtuple(
    'Span', 'id name request parent thread t0_ns t1_ns')
Request = collections.namedtuple('Request', 'id name parent')

_ids = itertools.count(1)


class Ring:
    """The bounded store of spans, requests and their counters. A full ring
    drops its oldest span (and request) for each new one and counts the
    spans dropped."""

    def __init__(self, capacity):
        self.capacity = capacity
        self._lock = threading.Lock()
        self.clear()

    def clear(self):
        with self._lock:
            self._spans = collections.deque(maxlen=self.capacity)
            self._requests = collections.OrderedDict()
            self._dropped = 0

    def add_span(self, span):
        with self._lock:
            if len(self._spans) == self.capacity:
                self._dropped += 1
            self._spans.append(span)

    def add_request(self, request):
        with self._lock:
            if len(self._requests) == self.capacity:
                self._requests.popitem(last=False)
            self._requests[request.id] = (request, collections.Counter())

    def count(self, request_id, name):
        with self._lock:
            kept = self._requests.get(request_id)
            if kept is not None:
                kept[1][name] += 1

    def snapshot(self):
        """{'spans': [Span], 'requests': {id: Request}, 'counters': {request
        id: {name: n}} (requests with a count), 'dropped': spans dropped}."""
        with self._lock:
            return {'spans': list(self._spans),
                    'requests': {i: r for i, (r, _) in self._requests.items()},
                    'counters': {i: dict(c) for i, (_, c)
                                 in self._requests.items() if c},
                    'dropped': self._dropped}


_RING = Ring(RING_SPANS)


class _Local(threading.local):
    request = None              # the current recorded Request, or None

    def __init__(self):
        self.stack = []         # ids of the spans open on this thread


_local = _Local()
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ('name', 'request', 'id', 'parent', 't0', 'rf')

    def __init__(self, name, request):
        self.name = name
        self.request = request

    def __enter__(self):
        stack = _local.stack
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(PREFIX + self.name)
        # the profiler takes its start early in the enter: the first enter
        # of a process then spends ~1 ms setting up after it
        self.t0 = time.time_ns()
        if self.rf is not None:
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _local.stack.pop()
        _RING.add_span(Span(self.id, self.name, self.request, self.parent,
                            threading.get_native_id(), self.t0, t1))
        return False


def span(name):
    """A context that records the work inside it as span `name` of the
    current request; a shared no-op outside a recorded call."""
    request = _local.request
    if request is None:
        return _OFF
    return _Span(name, request.id)


def count(name):
    """Add one to the current request's counter `name` (nothing outside a
    recorded call)."""
    request = _local.request
    if request is not None:
        _RING.count(request.id, name)


def _new_request(name, parent):
    request = Request(next(_ids), name, parent)
    _RING.add_request(request)
    return request


def entry(name):
    """Decorate an entry point: a call made while this thread's profiler
    records is a request of its own (a child of the current one, if any),
    spanned by `name`."""
    def decorate(fn):
        @functools.wraps(fn)
        def entered(*args, **kwargs):
            outer = _local.request
            if outer is None and not torch.autograd._profiler_enabled():
                return fn(*args, **kwargs)
            request = None
            if torch.autograd._profiler_enabled():
                request = _new_request(name, outer and outer.id)
            _local.request = request
            try:
                with span(name):
                    return fn(*args, **kwargs)
            finally:
                _local.request = outer
        return entered
    return decorate


def fork():
    """A child request ('pair') of the current one, for work that another
    thread does on its behalf; None outside a recorded call."""
    outer = _local.request
    return None if outer is None else _new_request('pair', outer.id)


def current():
    """This thread's current request (None outside a recorded call), for a
    helper thread that does part of the same request's work to install."""
    return _local.request


@contextlib.contextmanager
def installed(request):
    """Make `request` (from fork, or None) this thread's current request
    for the duration."""
    outer = _local.request
    _local.request = request
    try:
        yield
    finally:
        _local.request = outer


def snapshot():
    """The spans, requests and counters recorded so far (Ring.snapshot)."""
    return _RING.snapshot()


def clear():
    """Forget every span, request and count recorded so far."""
    _RING.clear()
