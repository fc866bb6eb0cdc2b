"""The forward step and the decode loops as captured CUDA graphs.

Counterpart of the reference's compiled programs: its jitted step
(blama_tpu/models/llama.py:953 make_step_fn, bound by
blama_tpu/runtime/instance.py:149) and its four loops, each a lax.scan
inside one jit (blama_tpu/ops/generate_loop.py:228-415). On the card a
forward is some 3000 launches, each ~14-20 us of host time when Python
dispatches it and ~1.6 us when a graph replays it (PERF.md §5), so a
StepGraphs captures

  * `step`: one forward at (static config, store, B, T): its inputs
    (tokens, positions, slots, logits index) are copied into static buffers
    and its [B, V] f32 logits into a static output;
  * `loop`: one step of a decode loop (the token: the argmax of the carried
    logits, or a forced one; the forward; the top-10, the claimed ids'
    logits; position + 1). Its carries (logits, positions, a device step
    index) live in static buffers, and it writes its outputs at the step
    index into buffers of LOOP_CHUNK steps, copied out once a chunk. n
    steps are n replays with no host copy or sync between them (CHECK_SYNC
    makes the card raise on one).

A replay runs the same kernels at the same shapes on the same buffers, so
every bit is the eager run's. The graphs of one owner (an Instance, a
scheduler, a loop call) share one memory pool: they never run at the same
time, and nothing in the pool outlives a replay (inputs and outputs are
static buffers made outside it). A graph's key holds the data pointers of
the stores it writes, so a reallocated store is captured anew; `retain`
drops the graphs of stores an owner no longer holds, and each graph holds
the tensors its pointers point at.

A capture first sets the inputs to pads (every slot is the store's spare
slot, which nothing reads), then runs the step once eagerly on the capture
stream (the warm-up: it builds the kernels' libraries and fills the lazy
caches, so the capture allocates nothing that outlives it) and captures it.
Neither changes state a later step reads, and neither counts a launch: the
capture records them and each replay adds them (ops/kernels.py). On the CPU
there is no graph: the loops and steps run eagerly, unless a test passes
StubBackend, whose "graph" reruns the captured function at each replay.
`capture_guard` makes the host reads a capture forbids raise on the CPU.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import logging
import threading
import time

import torch

from . import decode_attention as dattn
from . import kernels
from . import paged_kv as pkv

LOOP_CHUNK = 32      # steps held by a loop graph's output buffers
MAX_GRAPHS = 32      # graphs one owner keeps; the oldest is dropped first
# loops raise if anything syncs with the host between their replays
# (torch.cuda.set_sync_debug_mode "error"); the card's tests and chip_smoke.py
# set it, the server does not (the mode is process-wide)
CHECK_SYNC = False

_log = logging.getLogger("blama_tpu_torch")


# ---------------------------------------------------------------------------
# the host-read guard
# ---------------------------------------------------------------------------

class HostAccess(RuntimeError):
    """A host read or a tensor made from host data inside a guarded step."""


# what a capture forbids: reads of device data on the host, and tensors made
# from host data (a host-to-device copy)
HOST_READS = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__", "__float__")
HOST_DATA = ("tensor", "as_tensor", "from_numpy")
_guard = threading.local()
_guard_lock = threading.Lock()
_guard_users = 0
_saved: dict = {}


def _guarded(what: str, fn):
    @functools.wraps(fn)
    def run(*args, **kwargs):
        if getattr(_guard, "depth", 0) and not kernels.in_plain_version():
            raise HostAccess(f"{what} inside a captured step")
        return fn(*args, **kwargs)
    return run


@contextlib.contextmanager
def capture_guard():
    """Within it, in this thread, Tensor.item / tolist / cpu / numpy, a
    tensor's bool / int / float and torch.tensor / as_tensor / from_numpy
    raise HostAccess, except inside a kernel's plain version
    (kernels.plain_version: on the card the kernel runs in its place)."""
    global _guard_users
    with _guard_lock:
        if _guard_users == 0:
            for name in HOST_READS:
                _saved["Tensor." + name] = torch.Tensor.__dict__.get(name)
                setattr(torch.Tensor, name,
                        _guarded("Tensor." + name, getattr(torch.Tensor, name)))
            for name in HOST_DATA:
                _saved["torch." + name] = getattr(torch, name)
                setattr(torch, name, _guarded("torch." + name, getattr(torch, name)))
        _guard_users += 1
    _guard.depth = getattr(_guard, "depth", 0) + 1
    try:
        yield
    finally:
        _guard.depth -= 1
        with _guard_lock:
            _guard_users -= 1
            if _guard_users == 0:
                for name in HOST_READS:
                    held = _saved.pop("Tensor." + name)
                    if held is None:
                        delattr(torch.Tensor, name)
                    else:
                        setattr(torch.Tensor, name, held)
                for name in HOST_DATA:
                    setattr(torch, name, _saved.pop("torch." + name))


# ---------------------------------------------------------------------------
# where a graph is captured
# ---------------------------------------------------------------------------

class CudaBackend:
    """torch.cuda graphs: warm-up and capture on one side stream (so cuBLAS
    has its workspace for that stream before the capture), one memory pool
    for every graph of the owner."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)

    def warm(self, fn) -> None:
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            fn()
        cur.wait_stream(self.stream)

    def capture(self, fn):
        # A dropped owner's graphs wait in reference cycles (their closures
        # hold the owner) until Python's collector frees them, and a graph
        # freed while this thread captures breaks the capture (its
        # destructor is not permitted then). So the collector waits until
        # the capture ends.
        collecting = gc.isenabled()
        gc.disable()
        try:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                  capture_error_mode="thread_local"):
                fn()
        finally:
            if collecting:
                gc.enable()
        return graph


class _Rerun:
    """StubBackend's graph: a replay reruns the captured function, guarded,
    its launches counted by the replay alone."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self) -> None:
        with capture_guard(), kernels.uncounted():
            self.fn()


class StubBackend:
    """Stands in for torch.cuda.CUDAGraph where there is none (the CPU
    tests): the capture calls the function once under capture_guard, as a
    capture does, and each replay calls it again."""

    def warm(self, fn) -> None:
        fn()

    def capture(self, fn) -> _Rerun:
        with capture_guard():
            fn()
        return _Rerun(fn)


# ---------------------------------------------------------------------------
# the graphs of one owner
# ---------------------------------------------------------------------------

def store_key(cache) -> tuple:
    """What a graph bakes in of a store: its tensors' addresses and shapes
    (the page table's too) and its geometry."""
    tensors = (cache.k_store, cache.v_store, cache.pos_store, cache.k_scale_store,
               cache.v_scale_store, getattr(cache, "page_table", None))
    return (type(cache).__name__, cache.n_slots, getattr(cache, "batch", None),
            getattr(cache, "page_size", None),
            *((t.data_ptr(), tuple(t.shape)) if t is not None else None for t in tensors))


def n_vocab(params) -> int:
    """The lm head's width: a dense [E, V] weight or a packed one's n_out."""
    out = params["output"]
    return out.shape[1] if isinstance(out, torch.Tensor) else out.n_out


class _Graph:
    """A captured graph, the launches its capture recorded, its static
    buffers, and the objects its pointers point at (held, so no address is
    reused while it lives)."""

    def __init__(self, graph, launches: dict, buffers: dict, held: tuple):
        self.graph, self.launches, self.buffers, self.held = graph, launches, buffers, held

    def replay(self) -> None:
        self.graph.replay()
        kernels.add_launches(self.launches)


@contextlib.contextmanager
def _no_sync(device: torch.device):
    if not (CHECK_SYNC and device.type == "cuda"):
        yield
        return
    held = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(held)


class StepGraphs:
    """The captured steps and loop bodies of one owner, keyed by (what,
    static config, shape, head-batched flag, weights, store)."""

    def __init__(self, device, backend=None):
        self.device = torch.device(device)
        self.backend = backend if backend is not None else CudaBackend(self.device)
        self._graphs: dict[tuple, _Graph] = {}
        # every capture: what, seconds (warm-up included), GiB the card's
        # reserved memory grew by (the pool and the static buffers)
        self.captures: list[dict] = []

    def keys(self) -> list[tuple]:
        return list(self._graphs)

    def retain(self, cache) -> None:
        """Drop every graph captured on another store than `cache`'s."""
        keep = store_key(cache)
        for key in [k for k in self._graphs if k[-1] != keep]:
            del self._graphs[key]

    def pool_gib(self) -> float:
        return sum(c["gib"] for c in self.captures)

    def _reserved(self) -> int:
        """The card's reserved memory with the allocator's free cache
        returned (a capture returns it too), so a capture's growth is what
        its graph and buffers hold."""
        if self.device.type != "cuda":
            return 0
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved(self.device)

    def _get(self, key: tuple, build, what: str) -> _Graph:
        g = self._graphs.get(key)
        if g is not None:
            return g
        if len(self._graphs) >= MAX_GRAPHS:
            del self._graphs[next(iter(self._graphs))]
        t0, mem0 = time.perf_counter(), self._reserved()
        fn, buffers, held = build()
        with kernels.uncounted():
            self.backend.warm(fn)
        with kernels.recording() as launches:
            graph = self.backend.capture(fn)
        g = self._graphs[key] = _Graph(graph, launches, buffers, held)
        secs = time.perf_counter() - t0
        self.captures.append(dict(graph=what, seconds=secs,
                                  gib=(self._reserved() - mem0) / 2 ** 30))
        _log.info("captured %s in %.3f s", what, secs)
        return g

    # -- one forward ---------------------------------------------------------

    def prepare_step(self, st, params, cache, B: int, T: int) -> _Graph:
        """The graph of st.step at [B, T] on `cache`, captured if new."""
        key = ("step", st, B, T, dattn._HB, id(params), store_key(cache))
        return self._get(key, lambda: self._build_step(st, params, cache, B, T),
                         f"step B={B} T={T}")

    def _build_step(self, st, params, cache, B, T):
        dev = cache.device
        b = dict(tokens=torch.zeros((B, T), dtype=torch.int32, device=dev),
                 positions=torch.zeros((B, T), dtype=torch.int32, device=dev),
                 slots=torch.full((B, T), cache.n_slots, dtype=torch.int32, device=dev),
                 logits_index=torch.zeros((B,), dtype=torch.long, device=dev),
                 out=torch.empty((B, n_vocab(params)), dtype=torch.float32, device=dev))

        def fn():
            logits, _ = st.step(params, b["tokens"], b["positions"], b["slots"], cache,
                                b["logits_index"])
            b["out"].copy_(logits)
        return fn, b, (params, cache)

    def step(self, st, params, cache, tokens, positions, slots, logits_index) -> torch.Tensor:
        """st.step(params, tokens, positions, slots, cache, logits_index)
        through its graph: the [B, V] f32 logits, in a buffer that the next
        replay of this graph overwrites."""
        g = self.prepare_step(st, params, cache, *tokens.shape)
        b = g.buffers
        for name, t in (("tokens", tokens), ("positions", positions), ("slots", slots),
                        ("logits_index", logits_index)):
            b[name].copy_(t)
        g.replay()
        return b["out"]

    # -- a decode loop ---------------------------------------------------------

    def _build_loop(self, st, params, cache, B, top, full, claimed):
        dev, C, V = cache.device, LOOP_CHUNK, n_vocab(params)
        z = functools.partial(torch.zeros, device=dev)
        b = dict(logits=z((B, V), dtype=torch.float32), pos=z((B,), dtype=torch.int32),
                 step=z((1,), dtype=torch.long), zero=z((B,), dtype=torch.long),
                 forced=torch.full((B, C), -2, dtype=torch.int32, device=dev),
                 toks=z((B, C), dtype=torch.int32))
        if top:
            b.update(top_ids=z((B, C, 10), dtype=torch.long),
                     top_vals=z((B, C, 10), dtype=torch.float32))
        if claimed:
            b.update(claimed=z((B, C, 10), dtype=torch.long),
                     claimed_vals=z((B, C, 10), dtype=torch.float32))
        if full:
            b["full"] = z((B, C, V), dtype=torch.float32)
        paged = isinstance(cache, pkv.PagedKVCache)
        n_slots = cache.n_slots   # a slot >= n_slots is a pad

        def fn():
            i, pos = b["step"], b["pos"]
            forced = b["forced"].index_select(1, i)[:, 0]
            greedy = torch.argmax(b["logits"], dim=-1).to(torch.int32)
            tok = torch.where(forced >= 0, torch.clamp(forced, min=0), greedy)
            if paged:
                G = cache.page_size
                page = torch.gather(cache.page_table, 1,
                                    torch.div(pos, G, rounding_mode="floor")[:, None].long())[:, 0]
                slot = torch.where(forced == -2, n_slots, page * G + pos % G)
            else:
                slot = torch.where(forced == -2, n_slots, pos)
            logits, _ = st.step(params, tok[:, None], pos[:, None], slot[:, None], cache,
                                b["zero"])
            b["toks"].index_copy_(1, i, tok[:, None])
            if top:
                vals, ids = torch.topk(logits, 10, dim=-1)
                b["top_vals"].index_copy_(1, i, vals[:, None])
                b["top_ids"].index_copy_(1, i, ids[:, None])
            if claimed:
                ids = b["claimed"].index_select(1, i)[:, 0]
                b["claimed_vals"].index_copy_(1, i, torch.gather(logits, 1, ids)[:, None])
            if full:
                b["full"].index_copy_(1, i, logits[:, None])
            b["logits"].copy_(logits)
            pos.add_(1)
            i.add_(1)
        return fn, b, (params, cache)

    def loop(self, st, params, cache, logits0, pos0, n: int, forced=None, claimed=None,
             top: bool = False, full: bool = False) -> dict:
        """n steps of a decode loop from logits0 [B, V] and pos0 [B] (the
        next position, = slot on dense rows), one replay each. forced [B, n]
        int32 on the device: a token >= 0 is fed, -1 takes the argmax, -2
        idles the row (its writes go to the spare slot); None: the argmax
        throughout. claimed [B, n, 10] ids on the device: their logits each
        step. Returns toks [B, n] int32 and, as asked, top_ids / top_vals
        [B, n, 10], claimed_vals [B, n, 10], full [B, n, V] f32; and
        logits [B, V], the last step's."""
        B = pos0.shape[0]
        key = ("loop", st, B, top, full, claimed is not None, dattn._HB, id(params),
               store_key(cache))
        g = self._get(key, lambda: self._build_loop(st, params, cache, B, top, full,
                                                    claimed is not None),
                      f"loop B={B}" + " top" * top + " full" * full
                      + " claimed" * (claimed is not None))
        b, C = g.buffers, LOOP_CHUNK
        b["logits"].copy_(logits0)
        b["pos"].copy_(pos0)
        if forced is None:
            b["forced"].fill_(-1)
        names = [k for k in ("toks", "top_ids", "top_vals", "claimed_vals", "full") if k in b]
        outs = {k: torch.empty((B, n) + b[k].shape[2:], dtype=b[k].dtype, device=cache.device)
                for k in names}
        with _no_sync(cache.device):
            for c0 in range(0, n, C):
                m = min(C, n - c0)
                b["step"].zero_()
                if forced is not None:
                    b["forced"][:, :m].copy_(forced[:, c0:c0 + m])
                if claimed is not None:
                    b["claimed"][:, :m].copy_(claimed[:, c0:c0 + m])
                for _ in range(m):
                    g.replay()
                for k in names:
                    outs[k][:, c0:c0 + m].copy_(b[k][:, :m])
        outs["logits"] = b["logits"].clone()
        return outs


def graphs_for(graphs, device: torch.device) -> StepGraphs | None:
    """The StepGraphs a loop runs through: the caller's; a new one on the
    card when given None; none (eager launches) when given False, and on
    the CPU unless a StepGraphs is given."""
    if isinstance(graphs, StepGraphs):
        return graphs
    if graphs is False or device.type != "cuda":
        return None
    return StepGraphs(device)
