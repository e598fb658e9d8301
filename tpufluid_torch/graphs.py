"""CUDA graphs of the step bursts: the counterpart of the JAX package's
``jax.jit(lax.scan(step))``, which runs a burst of ticks as one device
program with no host round-trip between ticks; and of the sharded steps'
``jax.jit(shard_map(step))``, one device program a call (``CallGraph``).

A burst's step is captured once as a CUDA graph over static buffers: the
state it reads (and overwrites with its result), the params' copies and
any field's. A burst copies its inputs into them, replays the graph once
per step and hands back a copy of the result, never a buffer that the
next replay overwrites. The first burst runs its first step eagerly, on a
side stream (that step builds the kernels, sets their shared-memory limits
and fills the step's caches, none of which a capture may do), and captures
the graph from that step's result. A replay launches the same kernels in
the same order as the eager step, so a graphed burst is bitwise its eager
burst. A capture that fails raises; nothing falls back to the eager loop.

Launch counts: a kernel wrapper counts a launch when Python calls it,
which a replay does not do. The counts a capture made are taken back and
added again on every replay, so the counters read the launches that ran.
A sharded step's mesh notes its collectives as Python makes them; a
``CallGraph`` keeps its capture's notes and notes them again per replay.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import time

import torch

from .utils.profiling import span


def _counters():
    """Every kernel wrapper's launch-count dict."""
    from .ops import far_sharded, fused, rebin, render_coarse, resident, sph

    return (fused.LAUNCHES, rebin.LAUNCHES, render_coarse.LAUNCHES,
            sph.LAUNCHES, resident.LAUNCHES, far_sharded.LAUNCHES)


def signature(obj) -> tuple:
    """Shapes and types of a dataclass of tensors (the static copies a
    graph of it holds)."""
    return tuple((f.name, tuple(getattr(obj, f.name).shape),
                  getattr(obj, f.name).dtype)
                 for f in dataclasses.fields(obj))


def clone_fields(obj, device=None):
    """A copy of a dataclass of tensors, each field cloned (onto
    ``device`` where given)."""
    def one(t):
        return (t if device is None else t.to(device)).clone()

    return dataclasses.replace(obj, **{
        f.name: one(getattr(obj, f.name)) for f in dataclasses.fields(obj)})


def copy_fields(dst, src) -> None:
    """Each tensor field of ``src`` copied into ``dst``'s, in place."""
    for f in dataclasses.fields(dst):
        getattr(dst, f.name).copy_(getattr(src, f.name))


def on_side_stream(fn, device):
    """``fn()`` on a side stream that first waits for the current stream,
    which then waits for it (PyTorch's warm-up before a capture)."""
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out = fn()
    cur.wait_stream(side)
    return out


def node_count(graph: torch.cuda.CUDAGraph):
    """Nodes of a captured graph (libcuda's ``cuGraphGetNodes``), or None
    where ``libcuda.so.1`` does not load."""
    try:
        lib = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return None
    fn = lib.cuGraphGetNodes
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_size_t)]
    n = ctypes.c_size_t(0)
    err = fn(ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    return int(n.value) if err == 0 else None


# every capture's record: what, capture_s, instantiate_s, nodes, launches
CAPTURES: list = []
# the burst runners by key: (family, runner)
_RUNNERS: dict = {}


def burst(key, family, device, n_steps: int, step, build, state, *inputs):
    """``n_steps`` of ``step(state, *inputs)`` as a burst: the calls of the
    runner cached under ``key`` (``runner(state, n_steps, *inputs)``,
    replays of a graph). A key's first burst runs its first step eagerly on
    a side stream, then builds the runner from that step's result
    (``build(state, *inputs)``), dropping the runners of the same
    ``family`` under other keys (a step's graphs go when the step is
    rebuilt at another cell capacity)."""
    if n_steps <= 0:
        return state
    hit = _RUNNERS.get(key)
    if hit is None:
        state = on_side_stream(lambda: step(state, *inputs), device)
        for k in [k for k, (f, _) in _RUNNERS.items() if f == family]:
            del _RUNNERS[k]
        hit = _RUNNERS[key] = (family, build(state, *inputs))
        n_steps -= 1
        if n_steps == 0:
            return state
    return hit[1](state, n_steps, *inputs)


class StepGraph:
    """``body()`` captured as a CUDA graph on ``device``; ``replay(n)`` runs
    it n times on the current stream. ``capture_s``, ``instantiate_s``:
    the host seconds of the capture and of the instantiation; ``nodes``:
    the graph's node count; ``launches``: the kernel launches of one
    replay, by counter."""

    def __init__(self, body, device, what: str):
        with span("tpufluid_torch.capture"):
            self._capture(body, torch.device(device), what)

    def _capture(self, body, device, what: str) -> None:
        counts = _counters()
        before = [dict(c) for c in counts]
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(self.graph, stream=stream):
                body()
            t1 = time.perf_counter()
            self.graph.instantiate()
        except Exception as err:
            raise RuntimeError(f"capturing {what} as a CUDA graph failed: "
                               f"{err}") from err
        finally:
            delta = [{n: c[n] - b.get(n, 0) for n in c}
                     for c, b in zip(counts, before)]
            for c, b in zip(counts, before):
                c.update(b)
        self.instantiate_s = time.perf_counter() - t1
        self.capture_s = t1 - t0
        self.nodes = node_count(self.graph)
        self._delta = [{n: v for n, v in d.items() if v} for d in delta]
        self.launches = {n: v for d in self._delta for n, v in d.items()}
        CAPTURES.append(dict(what=what, capture_s=self.capture_s,
                             instantiate_s=self.instantiate_s,
                             nodes=self.nodes, launches=self.launches))

    def replay(self, n: int) -> None:
        for _ in range(n):
            self.graph.replay()
        for counts, d in zip(_counters(), self._delta):
            for name, v in d.items():
                counts[name] += v * n


def flatten(obj, out=None):
    """(tensors, spec) of a tree of tensors: dataclasses, tuples, lists,
    dicts and None around them. ``unflatten(spec, tensors)`` rebuilds it."""
    out = [] if out is None else out
    if isinstance(obj, torch.Tensor):
        out.append(obj)
        spec = "t"
    elif obj is None:
        spec = None
    elif dataclasses.is_dataclass(obj):
        spec = (type(obj), tuple((f.name, flatten(getattr(obj, f.name),
                                                  out)[1])
                                 for f in dataclasses.fields(obj)))
    elif isinstance(obj, (tuple, list)):
        spec = (type(obj), tuple(flatten(x, out)[1] for x in obj))
    elif isinstance(obj, dict):
        spec = (dict, tuple((k, flatten(v, out)[1]) for k, v in obj.items()))
    else:
        raise TypeError(f"not a tensor tree: {type(obj).__name__}")
    return out, spec


def unflatten(spec, tensors):
    it = iter(tensors)

    def build(sp):
        if sp == "t":
            return next(it)
        if sp is None:
            return None
        kind, parts = sp
        if kind is dict:
            return {k: build(v) for k, v in parts}
        if kind in (tuple, list):
            return kind(build(v) for v in parts)
        return kind(**{k: build(v) for k, v in parts})

    return build(spec)


class CallGraph:
    """``fn(*args)`` captured once as a CUDA graph over static copies of
    the tensors of ``args`` (``flat``, ``spec``: ``flatten(args)``); a call
    with the tensors of arguments of the same structure and shapes copies
    them in, replays once, and hands back clones of the outputs in
    ``fn``'s structure, never the static buffers. ``mesh``: a sharded
    step's mesh; the collectives the capture noted are noted again on
    every replay (``Mesh.replayed``), so an audit of a replay counts one
    step's traffic."""

    def __init__(self, fn, flat, spec, device, what: str, mesh=None):
        self.inputs = [t.clone() for t in flat]
        self._out = None
        self.mesh = mesh

        def body():
            self._out = flatten(fn(*unflatten(spec, self.inputs)))

        with (mesh.recording() if mesh is not None
              else contextlib.nullcontext()) as notes:
            self.graph = StepGraph(body, device, what)
        self.notes = notes

    def __call__(self, flat):
        for dst, src in zip(self.inputs, flat):
            dst.copy_(src)
        self.graph.replay(1)
        if self.mesh is not None:
            self.mesh.replayed(self.notes)
        outs, spec = self._out
        return unflatten(spec, [t.clone() for t in outs])


def graphed_calls(fn, device, what: str, mesh=None):
    """``call(*args)``: ``fn(*args)`` replayed as a ``CallGraph``, one per
    argument structure with its tensors' shapes, dtypes and devices. Its
    first call runs ``fn`` eagerly on a side stream (kernel builds,
    shared-memory limits, cached tables), returns that result and captures
    the graph from its arguments; later calls replay."""
    cache = {}

    def call(*args):
        flat, spec = flatten(args)
        key = (spec, tuple((tuple(t.shape), t.dtype, t.device)
                           for t in flat))
        g = cache.get(key)
        if g is None:
            out = on_side_stream(lambda: fn(*args), device)
            cache[key] = CallGraph(fn, flat, spec, device, what, mesh)
            return out
        return g(flat)

    return call
