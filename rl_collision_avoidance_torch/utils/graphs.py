"""CUDA graphs of the acting step: a step's small launches replayed as one.

The acting step outside ``Env.step`` (the policy forward, the Gaussian
sample and its log-prob, the trajectory writes; in the eval the mean
action and the first-result bookkeeping) is some 40 small launches that
read nothing back to the host, over shapes fixed for a whole rollout or
eval call.  On the card the host takes longer to enqueue them than the card
takes to run them.  :class:`Step` captures such a step once as a
``torch.cuda.CUDAGraph`` over static tensors and replays it at every call.
Its owner keeps it under :func:`key`, what a capture depends on that the
code can observe: the device, the inputs' shapes and dtypes, the policy's
compute dtype and its parameters' addresses.  A ``load_state_dict`` or an
optimizer step writes the parameters in place and keeps the graph;
parameters put in new tensors give a new key.  On the CPU a step runs
eagerly.

:data:`captures` and :data:`replays` count what happened on the card.  The
kernels' ``launches`` counters (``ops/*_cuda.py``) count launches through
:func:`launched`: a kernel captured into a graph counts at each replay,
which launches it, and not at its capture, which does not.
"""
from __future__ import annotations

import contextlib

import torch

#: Graphs captured since the count was last set to 0.
captures = 0
#: Replays of captured graphs since the count was last set to 0.
replays = 0

#: Eager runs of a step on the capture's side stream before its capture,
#: as ``torch.cuda.graphs`` prescribes: lazy initializations (a kernel's
#: module load, cuBLAS's workspace) happen outside the capture.
WARMUP = 3

#: While a :class:`Step` is captured, the launch counts of the kernels
#: captured so far, as (count, args) for :func:`launched`.
_recording: list | None = None


def captured_on(device) -> bool:
    """Whether steps on ``device`` are captured: on the CUDA card; the CPU
    runs them eagerly."""
    return torch.device(device).type == "cuda"


def key(module: torch.nn.Module, *tensors: torch.Tensor) -> tuple:
    """What a graph of ``module``'s step over inputs like ``tensors``
    depends on, as (layout, parameters): their device, shapes and dtypes
    and the module's compute dtype; the address of each parameter."""
    return ((tuple((t.device, t.dtype, tuple(t.shape)) for t in tensors),
             module.dtype), tuple(p.data_ptr() for p in module.parameters()))


def launched(count, *args) -> None:
    """A kernel wrapper's count of one launch, ``count(*args)``: now, or,
    where the launch is being captured into a :class:`Step`'s graph, at
    each replay of it."""
    if _recording is None:
        count(*args)
    else:
        _recording.append((count, args))


@contextlib.contextmanager
def recorded_launches():
    """Inside the block :func:`launched` keeps the counts in the list it
    yields instead of counting them."""
    global _recording
    _recording = kept = []
    try:
        yield kept
    finally:
        _recording = None


class Step:
    """``fn()``, a step whose inputs and outputs are tensors it closes over,
    on ``device``.  The caller writes the inputs in place before each call.
    On the card the constructor captures ``fn`` as a CUDA graph, which each
    call replays, and a call returns what ``fn`` returned at its capture,
    rewritten by the replay; the step then drops ``fn``, and with it what
    ``fn`` closed over (the policy).  Elsewhere a call runs ``fn``.  The
    capture runs ``fn`` :data:`WARMUP` times eagerly first, so state that
    ``fn`` advances is the caller's to reset after constructing the step."""

    def __init__(self, fn, device):
        self.fn, self.graph, self.out, self.launches = fn, None, None, []
        if captured_on(device):
            self._capture(torch.device(device))
            self.fn = None

    def _capture(self, device: torch.device) -> None:
        global captures
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        graph = torch.cuda.CUDAGraph()
        with torch.no_grad():
            with torch.cuda.stream(stream):
                for _ in range(WARMUP):
                    self.fn()
            # thread_local: other threads' CUDA calls (a process group's
            # watchdog) do not break this thread's capture
            with recorded_launches() as self.launches, torch.cuda.graph(
                    graph, stream=stream, capture_error_mode="thread_local"):
                self.out = self.fn()
        torch.cuda.current_stream(device).wait_stream(stream)
        self.graph = graph
        captures += 1

    def __call__(self):
        if self.graph is None:
            return self.fn()
        global replays
        self.graph.replay()
        replays += 1
        for count, args in self.launches:
            count(*args)
        return self.out
