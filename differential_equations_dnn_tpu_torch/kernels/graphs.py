"""The CUDA-graph replay the fused trainers share (csrc/fused_step.cuh):
the heat kernel (#1) and both engines.

A training chunk of K steps on the card replays a CUDA graph of
GRAPH_STEPS steps ⌊K/GRAPH_STEPS⌋ times and runs the steps left over as the
same launches. What a shape's graph holds pointers to stays alive between
calls in a :class:`StepGraph`: the device argument block each call fills
with one copy (p, m, v, the uniforms, the losses, lr, the schedule, the
spec's numbers), the per-replica scratch, and the streams. The graphs are
cached by shape and precision (a "mixed" run holds two: its "default"
instances' and its "highest" ones'), least recently used first out
(``clear_graphs``). Every capture is a ``graph.capture`` span, apart from
the chunks' own times, and is counted, as is every cached shape freed to
make room (utils/trace.py: ``graph.captures.<trainer>``,
``graph.evictions``; a shape used again after that captures anew).

The generic trainers' graphs (train/trainer.py's scan step,
parallel/population.py's population step) are torch CUDA graphs, kept with
everything each holds pointers to in a :class:`GraphCache` of their own
(``TRAINER_GRAPHS``) by the keys those modules make, evicted and counted
the same way. ``clear_graphs`` frees both caches.

Capture and replay never use the legacy default stream (which
``current_stream()`` often is): a call's launches run on its shape's side
stream, which first waits for the caller's stream, and the caller's stream
then waits for it.
"""

import collections
import ctypes

import torch

from differential_equations_dnn_tpu_torch.kernels import build
from differential_equations_dnn_tpu_torch.utils import trace

# Training steps of one captured CUDA graph (S): a call of K steps replays
# it ⌊K/S⌋ times and runs the K mod S steps left over as the same launches.
GRAPH_STEPS = 50
# Shapes whose graphs (and scratch) stay cached, over all fused trainers: a
# sweep's four bucket tiles (sweep/search.py BUCKET_TILES) × {single trial,
# packed rung} × two precisions.
GRAPH_CACHE_SIZE = 16
# Keys whose generic-trainer graphs stay cached, over both trainers. One:
# the callers that repeat a key in a process (a loop of solves over seeds,
# a TPE sweep's rounds, a repeated ablation) repeat the last one, and each
# entry keeps its graph's memory pool (a population's ~4 GB) between calls.
TRAINER_CACHE_SIZE = 1


def args_block(nbytes, device):
    """Device memory for a kernels' argument block (``StepArgs``), which
    each C entry point fills with one copy on its stream."""
    return torch.empty(nbytes, dtype=torch.uint8, device=device)


class StepGraph:
    """What the training launches of one shape keep between calls: the
    argument block and the per-replica scratch that a captured graph holds
    pointers to, the side stream it is replayed on, two more streams for
    the weight gradients of the steps run outside the graph, and the
    instantiated graph of GRAPH_STEPS steps, once a call needs it."""

    def __init__(self, engine, device, n_replicas, floats, args_bytes,
                 free):
        self.engine = engine
        self.args = args_block(args_bytes, device)
        self.scratch = torch.empty(n_replicas * floats, device=device)
        self.stream = torch.cuda.Stream(device)
        self.branches = [torch.cuda.Stream(device) for _ in range(2)]
        self.exec = None
        self.sweep = ()  # the last call's sweep vectors, kept alive
        self._free = free

    def capture(self, build_graph, what):
        """Capture and instantiate the graph: ``build_graph(args, scratch,
        exec_out)`` is the engine's C entry point bound to its shape; raises
        if CUDA refuses either."""
        exec_ = ctypes.c_void_p()
        with trace.span("graph.capture", trainer=self.engine):
            build.check(build_graph(self.args.data_ptr(),
                                    self.scratch.data_ptr(),
                                    ctypes.byref(exec_)), what)
        self.exec = exec_.value
        trace.count(f"graph.captures.{self.engine}")

    def free(self):
        self.stream.synchronize()
        if self.exec is not None:
            build.check(self._free(self.exec), "graph free")
            self.exec = None

    def run(self, call, device):
        """``call(stream, side0, side1)`` (the engine's training entry point)
        on this shape's streams, ordered after and before the caller's."""
        caller = torch.cuda.current_stream(device)
        self.stream.wait_stream(caller)
        with torch.cuda.device(device):
            code = call(self.stream.cuda_stream,
                        *(b.cuda_stream for b in self.branches))
        caller.wait_stream(self.stream)
        return code


class GraphCache:
    """Entries kept by key, least recently used first out: past ``size``
    the oldest is freed (its ``free()``) and counted as a
    ``graph.evictions``. The fused trainers' :class:`StepGraph` s and the
    generic trainers' entries (train/trainer.py, parallel/population.py)
    each sit in one."""

    def __init__(self, size):
        self.size = size
        self.entries = collections.OrderedDict()

    def __contains__(self, key):
        return key in self.entries

    def get(self, key):
        """``key``'s entry, now the most recently used; None if there is
        none or ``key`` is None."""
        entry = None if key is None else self.entries.get(key)
        if entry is not None:
            self.entries.move_to_end(key)
        return entry

    def put(self, key, entry):
        """Keep ``entry`` under ``key``, freeing the least recently used
        past ``size``; returns ``entry``."""
        self.entries[key] = entry
        while len(self.entries) > self.size:
            self.entries.popitem(last=False)[1].free()
            trace.count("graph.evictions")
        return entry

    def pop(self, key):
        """Forget ``key``'s entry, if kept, without freeing it."""
        self.entries.pop(key, None)

    def clear(self):
        while self.entries:
            self.entries.popitem()[1].free()


_GRAPHS = GraphCache(GRAPH_CACHE_SIZE)
# The generic trainers' entries, by their modules' keys.
TRAINER_GRAPHS = GraphCache(TRAINER_CACHE_SIZE)


def cached(key):
    """True if ``key``'s shape has a cached entry."""
    return key in _GRAPHS


def step_graph(key, make):
    """The cached :class:`StepGraph` of ``key``, made by ``make()`` on
    first use; the least recently used of more than GRAPH_CACHE_SIZE is
    freed."""
    return _GRAPHS.get(key) or _GRAPHS.put(key, make())


def clear_graphs():
    """Free every cached graph, the generic trainers' too (the next call of
    each shape captures anew)."""
    _GRAPHS.clear()
    TRAINER_GRAPHS.clear()
