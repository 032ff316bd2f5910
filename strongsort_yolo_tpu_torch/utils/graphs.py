"""A pure fixed-shape step replayed as one CUDA graph.

:class:`StepGraph` takes a function of CUDA tensors (or None) whose
shapes never change, a step that reads nothing but its inputs and
returns a tuple of NamedTuples of tensors, the first of them the next
value of its leading inputs (a state in, the next state out), such as
the tracker's step (``Pipeline.associate``). Its first call steps the
function eagerly, which is the warm-up PyTorch asks for before a
capture, and returns that step's outputs; then it captures the function
on static input buffers.
Each later call copies the live inputs into those buffers, replays the
graph on the current stream and copies the graph's outputs into fresh
tensors, so nothing it returns is a buffer that a later replay
overwrites. Outputs that are one tensor in the function's result (a
state field that is also an output row) stay one tensor. The next
state is written back into the state's input buffers at the end of the
graph, so the graph holds the state once, not as an input and again as
an output.

The copies are :func:`copy_all`: one ``torch._foreach_copy_`` per
element size, so a replayed step launches a few copy kernels and one
graph where the function launched hundreds of kernels.

Kernel wrappers that count their launches (``fn.launches``) stay honest:
the capture launches nothing, so it leaves their counts as they were, and
each replay adds the launches the capture recorded.
"""

from __future__ import annotations

import torch

# the integer dtype of each element size: a copy of those bits is exact
# for any dtype of that size
_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def copy_all(dst, src) -> None:
    """``dst[i].copy_(src[i])`` for every i, bit for bit. Pairs of one
    dtype and shape that are both contiguous go as their bits, one
    ``torch._foreach_copy_`` per element size; any other pair is copied
    alone."""
    groups: dict[torch.dtype, tuple[list, list]] = {}
    for d, s in zip(dst, src, strict=True):
        bits = _BITS.get(d.element_size())
        if (bits is None or d.dtype != s.dtype or d.shape != s.shape
                or not (d.is_contiguous() and s.is_contiguous())):
            d.copy_(s)
            continue
        to, frm = groups.setdefault(bits, ([], []))
        to.append(d.view(bits))
        frm.append(s.view(bits))
    for to, frm in groups.values():
        torch._foreach_copy_(to, frm)


class StepGraph:
    """``fn`` captured once as a CUDA graph and replayed (the module's
    docstring). ``counted``: launch-counting kernel wrappers that ``fn``
    calls. After :meth:`capture`, ``graph`` is the captured graph, or
    None with ``error`` the reason where the capture failed;
    ``pool_bytes`` is what the capture added to the allocator's reserved
    memory (the graph's private pool)."""

    def __init__(self, fn, counted=()):
        self.fn = fn
        self.counted = tuple(counted)
        self.graph: torch.cuda.CUDAGraph | None = None
        self.error: BaseException | None = None
        self.pool_bytes = 0

    def capture(self, inputs):
        """The first call: ``fn(*inputs)`` stepped eagerly on a side
        stream, then captured there on static buffers of the inputs'
        shapes. -> the eager step's outputs, ordered on the current stream
        like any of its work. An error of the eager step propagates; a
        failed capture leaves ``graph`` None."""
        self.device = next(x.device for x in inputs if x is not None)
        with torch.cuda.device(self.device):
            self.stream = torch.cuda.current_stream()
            self.static = [None if x is None else torch.empty_like(
                x, memory_format=torch.contiguous_format) for x in inputs]
            side = torch.cuda.Stream()
            side.wait_stream(self.stream)
            for x in inputs:
                if x is not None:
                    x.record_stream(side)
            with torch.cuda.stream(side):
                first = self.fn(*inputs)
            self.stream.wait_stream(side)
            for group in first:
                for t in group:
                    t.record_stream(self.stream)
            self._capture(side)
        return first

    def _capture(self, side: torch.cuda.Stream) -> None:
        before = [f.launches for f in self.counted]
        reserved = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.stream(side):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    out = self.fn(*self.static)
                    held = {}  # the next state: back into its buffers
                    for buf, t in zip(self.static[:len(out[0])], out[0],
                                      strict=True):
                        buf.copy_(t)
                        held[id(t)] = buf
                finally:
                    graph.capture_end()
        except RuntimeError as err:
            self.error = err
            return
        finally:
            self.launches = [(f, f.launches - n)
                             for f, n in zip(self.counted, before)]
            for f, n in zip(self.counted, before):
                f.launches = n
        self.stream.wait_stream(side)
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        # the outputs once each, and where each goes in the result
        self.outs: list[torch.Tensor] = []
        where: dict[int, int] = {}
        self.layout = []
        for group in out:
            idx = []
            for t in group:
                t = held.get(id(t), t)
                if id(t) not in where:
                    where[id(t)] = len(self.outs)
                    self.outs.append(t)
                idx.append(where[id(t)])
            self.layout.append((type(group), idx))
        self.graph = graph

    def __call__(self, inputs):
        """A replay: ``inputs`` (of the captured shapes, None where the
        capture had None) copied in, the graph replayed on the current
        stream, its outputs copied into fresh tensors -> ``fn``'s result."""
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream()
            if stream != self.stream:  # the last replay's buffers in use there
                stream.wait_stream(self.stream)
                self.stream = stream
            copy_all([s for s in self.static if s is not None],
                     [x for x in inputs if x is not None])
            self.graph.replay()
            for f, n in self.launches:
                f.launches += n
            fresh = [torch.empty_like(t) for t in self.outs]
            copy_all(fresh, self.outs)
        return tuple(kind(*(fresh[i] for i in idx))
                     for kind, idx in self.layout)
