"""CUDA graphs of the steps: the counterpart of the JAX package's
``jax.jit(lax.scan(step))``, which runs a burst of ticks as one device
program with no host round-trip between ticks, and of the sharded steps'
``jax.jit(shard_map(step))``, one device program a call.

A step is captured once as a CUDA graph (``Graph``) over static copies of
its arguments: the state it reads (a burst's body writes its result back
into it), the params and any field. A call copies its inputs into them,
replays the graph once per step and hands back copies of the body's
outputs, never a buffer that the next replay overwrites. The graphs are
cached by key (``Runners``): a key's first call runs its first step
eagerly, on a side stream (that step builds the kernels, sets their
shared-memory limits and fills the step's caches, none of which a capture
may do), then captures the graph. A replay launches the same kernels in
the same order as the eager step, so a graphed burst is bitwise its eager
burst. A capture that fails raises; nothing falls back to the eager loop.
Calls are graphed where ``graphable`` says so.

Launch counts: a kernel wrapper counts a launch in ``_build.LAUNCHES``
when Python calls it, which a replay does not do. The counts a capture
made are taken back and added again on every replay, so the counter reads
the launches that ran. A sharded step's mesh notes its collectives as
Python makes them; a graph keeps its capture's notes and notes them again
per replay.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import time

import torch

from ._build import LAUNCHES
from .params import SimSettings
from .utils.profiling import span


def graphable(*devices) -> bool:
    """Whether calls on ``devices`` (a step's device, or a mesh's shards')
    replay a CUDA graph: all on one CUDA device. A mesh over several cards
    runs eagerly (a capture across cards is untested), as does the CPU."""
    return len(set(devices)) == 1 and devices[0].type == "cuda"


@functools.cache
def _field_names(kind) -> tuple:
    return tuple(f.name for f in dataclasses.fields(kind))


def signature(obj) -> tuple:
    """Shapes and types of a dataclass of tensors (the static copies a
    graph of it holds)."""
    return tuple((n, tuple(t.shape), t.dtype)
                 for n, t in ((n, getattr(obj, n))
                              for n in _field_names(type(obj))))


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


def leaves(obj, out=None) -> list:
    """``flatten(obj)[0]`` without the spec: a call's tensors, on the host
    path of every replay."""
    out = [] if out is None else out
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            leaves(x, out)
    elif isinstance(obj, dict):
        for x in obj.values():
            leaves(x, out)
    elif obj is not None:  # a dataclass
        for n in _field_names(type(obj)):
            leaves(getattr(obj, n), out)
    return out


def unflatten(spec, tensors):
    return _unflatten(spec, iter(tensors))


def _unflatten(spec, it):
    # a module-level recursion: a nested one would be a reference cycle
    # that keeps ``tensors`` (a call's results) alive until the collector
    # runs
    if spec == "t":
        return next(it)
    if spec is None:
        return None
    kind, parts = spec
    if kind is dict:
        return {k: _unflatten(v, it) for k, v in parts}
    if kind in (tuple, list):
        return kind(_unflatten(v, it) for v in parts)
    return kind(**{k: _unflatten(v, it) for k, v in parts})


# every capture's record: what, capture_s, instantiate_s, nodes, launches
CAPTURES: list = []


class Graph:
    """``body(*static)`` captured as one CUDA graph on ``device``, where
    ``static`` holds clones of the tensors of ``args`` in their tree. A
    call ``graph(flat, n)`` with the tensors of arguments of the same tree
    and shapes (``leaves(args)``) copies them in, replays ``n`` times
    and hands back clones of the body's outputs in its tree, never the
    static buffers; a body whose steps carry a state writes it back into
    its static arguments. ``mesh``: a sharded step's mesh; the collectives
    the capture noted are noted again on every replay
    (``Mesh.replayed``), so an audit of a replay counts one step's traffic.

    ``capture_s``, ``instantiate_s``: the host seconds of the capture and
    of the instantiation; ``nodes``: the graph's node count; ``launches``:
    the kernel launches of one replay, by name."""

    def __init__(self, body, args, device, what: str, mesh=None):
        flat, spec = flatten(args)
        self.static = [t.clone() for t in flat]
        self.mesh = mesh

        def run():
            self._outs, self._out_spec = flatten(
                body(*unflatten(spec, self.static)))

        with (mesh.recording() if mesh is not None
              else contextlib.nullcontext()) as notes, \
                span("tpufluid_torch.capture"):
            before = dict(LAUNCHES)
            try:
                self._capture(run, torch.device(device), what)
            finally:
                self.launches = {n: v - before[n]
                                 for n, v in LAUNCHES.items()
                                 if v != before[n]}
                LAUNCHES.update(before)
            CAPTURES.append(dict(what=what, capture_s=self.capture_s,
                                 instantiate_s=self.instantiate_s,
                                 nodes=self.nodes, launches=self.launches))
        self.notes = notes

    def _capture(self, run, device, what: str) -> None:
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(self.graph, stream=stream):
                run()
            t1 = time.perf_counter()
            self.graph.instantiate()
        except Exception as err:
            raise RuntimeError(f"capturing {what} as a CUDA graph failed: "
                               f"{err}") from err
        self.instantiate_s = time.perf_counter() - t1
        self.capture_s = t1 - t0
        self.nodes = node_count(self.graph)

    def replay(self, n: int) -> None:
        for _ in range(n):
            self.graph.replay()

    def __call__(self, flat, n: int = 1):
        for dst, src in zip(self.static, flat):
            dst.copy_(src)
        self.replay(n)
        for name, v in self.launches.items():
            LAUNCHES[name] += v * n
        if self.mesh is not None:
            for _ in range(n):
                self.mesh.replayed(self.notes)
        return unflatten(self._out_spec, [t.clone() for t in self._outs])


def _family(key) -> tuple:
    """``key`` with its settings' cell capacity taken out: the keys of the
    same step built at another K."""
    return tuple(dataclasses.replace(x, cell_capacity=1)
                 if isinstance(x, SimSettings) else x for x in key)


class Runners(dict):
    """Graphs by key, each with its family (``_family``): a capture drops
    the graphs of its family under other keys (a step's graphs go when the
    step is rebuilt at another cell capacity)."""

    def burst(self, key, device, n: int, step, body, what: str, *args,
              mesh=None):
        """``n`` calls of ``step(*args)``, each result the next call's
        first argument (a burst of steps; ``n = 1`` for a call), as
        replays of the ``Graph`` of ``body`` cached under ``key``. A key's
        first call runs ``step`` once eagerly on a side stream, then
        captures ``body`` over ``args``."""
        if n <= 0:
            return args[0]
        hit = self.get(key)
        if hit is None:
            out = on_side_stream(lambda: step(*args), device)
            family = _family(key)
            for k in [k for k, (f, _) in self.items() if f == family]:
                del self[k]
            hit = self[key] = (family, Graph(body, args, device, what,
                                             mesh))
            n -= 1
            if n == 0:
                return out
            args = (out,) + args[1:]
        return hit[1](leaves(args), n)


# the step bursts' graphs (a sharded step keeps its own)
_RUNNERS = Runners()
burst = _RUNNERS.burst
