"""Continuous-batching scheduler: many sequences share one batched decode.

Counterpart of blama_tpu/server/scheduler.py. The reference C++ server
serializes all requests through one Instance and one inference thread
(Server.cpp:27-36): correct but throughput-limited. This scheduler keeps a
fixed [B] batch of independent cache rows, per-request sampler state/seeds,
admission of new requests into free rows, and one batched decode step per
iteration. Verification requests run as teacher-forced batch rows;
row-level attention is independent per row so a sequence's logits do not
depend on its neighbors (batch invariance, tested in
tests/test_torch_scheduler.py).
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ..ops import decode_attention as dattn
from ..ops import kv_cache as kvc
from ..ops.step_graph import StepGraphs
from ..runtime.sampler import Sampler, SamplerParams
from ..runtime.token_data import TokenData, TokenPrediction
from ..utils.metrics import Metrics


@dataclass
class GenRequest:
    prompt: list[int]
    max_tokens: int = 128
    sampler_params: SamplerParams = field(default_factory=SamplerParams)
    on_token: Callable[[TokenPrediction], None] | None = None
    on_done: Callable[[list[TokenPrediction]], None] | None = None
    # why the request finished, set by the scheduler before on_done fires:
    # "stop" (EOG), "length" (max_tokens or context window), "evicted"
    # (paged pool ran dry),
    # "cancelled" (client disconnect), "rejected" (prompt exceeds the pool).
    # The reference C++ throws "context limit reached" (Session.cpp:331-333);
    # here failure is observable without aborting the whole batch.
    finish_reason: str | None = None
    # set via Scheduler.cancel() (client disconnect); the request finishes
    # early with whatever was generated, its row/pages are freed
    _cancel: threading.Event = field(default_factory=threading.Event)
    # paged preemption parking (scheduler-internal): when the pool runs dry
    # mid-decode and the request still FITS the pool solo, its row is
    # released and the request requeues with (resume_tokens, sampler,
    # generated) — it re-prefills prompt+generated when readmitted and
    # continues to completion instead of truncating (the
    # finish-early policy remains for requests that can no longer fit and
    # is surfaced as finish_reason="evicted")
    _resume: tuple | None = None
    # how many tokens had been generated at each preemption (observability:
    # tokens before the first entry are decode numerics throughout, later
    # ones continue from a re-prefill)
    preempted_at: list[int] = field(default_factory=list)
    _t_submit: float = 0.0  # monotonic time of the last (re)queueing


@dataclass
class VerifyRequest:
    """Teacher-forced verification as a batch row.

    Replays `predictions` (the prover's claimed tokens + top-10 logits)
    against the model, scoring each step with LogitComparer — the fillCtx
    flow (Session.cpp:231-244) as a scheduler row. Row-level attention is
    independent per row, so the score does not depend on what else shares
    the batch (batch invariance, tested in test_torch_scheduler.py); a scheduler
    prover replayed by a scheduler verifier at the same max_batch is
    bit-exact, while solo-Session cross-checks hold at the reference's
    cross-backend thresholds (t-LogitComparer.cpp:76-78)."""

    prompt: list[int]
    predictions: list[TokenPrediction]
    on_done: Callable[[float], None] | None = None
    # filled per step for inspection/tests: replayed TokenPredictions
    on_replayed: Callable[[list[TokenPrediction]], None] | None = None
    _t_submit: float = 0.0


@dataclass
class _Slot:
    request: GenRequest | None = None
    verify: VerifyRequest | None = None
    sampler: Sampler | None = None
    num_past: int = 0
    generated: list = field(default_factory=list)
    pending_token: int = -1
    last_logits: np.ndarray | None = None
    verify_idx: int = 0
    aggregator: object = None


class ContinuousBatchingScheduler:
    """`paged=True` switches the KV store to the shared page pool
    (ops/paged_kv.py): rows hold only the pages their context covers, and
    admission is bound by free pages instead of reserving a full
    ctx_size-slot row per request. `n_pages` sizes the pool (default: the
    same device memory as the dense layout, i.e. max_batch rows' worth —
    shrink it to oversubscribe). When the pool runs dry mid-decode the
    starved row is PREEMPTED: its pages are released and the request
    requeues, re-prefills its prompt + generated prefix when pages free up,
    and runs to completion (continuation numerics are re-prefill numerics).
    Only a request that no longer fits the pool even solo finishes early,
    with finish_reason="evicted" (the reference C++ analog is the hard
    "context limit reached" throw, Session.cpp:331-333).
    """

    def __init__(self, model, max_batch: int = 8, ctx_size: int = 0,
                 paged: bool = False, page_size: int = 128, n_pages: int = 0,
                 horizon: int = 0, graphs: bool = True):
        self.model = model
        cfg = model.config
        if cfg.arch == "gpt2":
            # the reference's scheduler builds LlamaStatic for every non-MoE
            # file, which cannot run a gpt2 file either
            raise NotImplementedError(
                "the continuous-batching scheduler serves llama-family and MoE "
                "files; gpt2 is served by the solo server (BLAMA_SCHEDULER=0)")
        self.B = max_batch
        self.S = ctx_size or cfg.n_ctx_train
        self.device = model.device
        if getattr(model.params, "mesh", None) is not None:
            raise NotImplementedError(
                "serving a sharded model is not ported "
                "(ROADMAP.md §1 item 13, multi-GPU)")
        # horizon > 1: decode up to `horizon` tokens per call of
        # ops/generate_loop.scheduler_loop with the logits held ON DEVICE
        # whenever every active row is device-eligible (greedy gen rows +
        # verify rows). The per-token path pulls [B, V] f32 logits to the
        # host every step. Composes with paged KV: pages for the whole
        # horizon are pre-allocated on the host and the device loop derives
        # flat pool slots from the page table per step.
        self.horizon = horizon
        self._dev_logits = None           # [B, V] f32 device tensor
        self._stale_host = set()          # rows whose slot.last_logits lags
        self._stale_dev = set()           # rows whose _dev_logits row lags
        emb_dtype = getattr(model.weights["tok_emb"], "dtype", torch.bfloat16)
        kv_dtype = torch.float32 if emb_dtype == torch.float32 else torch.bfloat16
        if cfg.attn_fused:   # attn="xla" (a MoE model): the two-pass chain only
            dattn.require_kernel_geometry(self.device, cfg.n_head, cfg.n_head_kv,
                                          cfg.head_dim_, kv_dtype)
        self.paged = paged
        self._head = None  # head-of-line request awaiting pool space (FIFO)
        if paged:
            from ..ops import paged_kv as pkv

            G = page_size
            MP = -(-self.S // G)
            self.S = MP * G  # logical row window, page-aligned
            P = n_pages or (self.B * MP)
            self.cache = pkv.PagedKVCache.create(
                cfg.n_layer, self.B, P, G, MP, cfg.n_head_kv, cfg.head_dim_,
                kv_dtype, device=self.device)
            self._alloc = pkv.PageAllocator(P, G, MP, self.B)
            self._pad_slot = P * G  # out-of-range -> the store's spare slot
        else:
            self.cache = kvc.KVCache.create(
                cfg.n_layer, self.B, self.S, cfg.n_head_kv, cfg.head_dim_,
                kv_dtype, device=self.device)
            self._pad_slot = self.S
        from ..ops.generate_loop import static_of

        # llama or MoE; every decode step has B·T > 1 rows, so a MoE model
        # takes its masked all-expert path throughout (rows batch-invariant)
        self._st = static_of(cfg)
        # on the card, the per-token step (T = 1) and the horizon loop replay
        # captured CUDA graphs (ops/step_graph.py); the joint prefill chunks,
        # whose [B, T] follows each admission, launch eagerly. graphs=False:
        # every step eager (for comparison)
        self._graphs = (StepGraphs(self.device)
                        if graphs and self.device.type == "cuda" else False)
        self._slots = [_Slot() for _ in range(self.B)]
        self._queue: queue.Queue[GenRequest] = queue.Queue()
        self.metrics = Metrics()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- device-op layer ------------------------------------------------------
    # Every mutation of device state (cache, _dev_logits) happens in the
    # _dev_* methods, which take host-serializable inputs only (numpy
    # arrays / ints / None). Host-side bookkeeping (slots, samplers,
    # admission) stays out, so a multi-GPU front end can replay the same calls
    # on follower processes that never see requests (ROADMAP.md §1 item 13).

    def _put(self, arr) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    @staticmethod
    def _host(t: torch.Tensor) -> np.ndarray:
        return t.cpu().numpy()

    def _dev_step(self, toks, pos, sl, li, table=None, capture=(),
                  pull=True):
        """One batched forward step; returns the [B, V] logits as a HOST
        array (None when `pull` is false — mid-prompt prefill chunks whose
        logits nobody reads skip the transfer). `table`: paged page-table
        snapshot to install first. `capture`: rows whose last-token logits
        this chunk holds — copied into the on-device logits buffer
        (horizon mode)."""
        if table is not None:
            self.cache.with_table(table)
        if self._graphs and toks.shape[1] == 1:
            logits = self._graphs.step(self._st, self.model.weights, self.cache,
                                       *map(torch.from_numpy, (toks, pos, sl, li)))
        else:
            logits, self.cache = self._st.step(
                self.model.weights, self._put(toks), self._put(pos), self._put(sl),
                self.cache, self._put(li))
        if len(capture):
            if self._dev_logits is None:
                self._dev_logits = torch.zeros_like(logits)
            rows = self._put(np.asarray(capture, np.int64))
            self._dev_logits[rows] = logits[rows]
        return self._host(logits) if pull else None

    def _dev_pull(self) -> np.ndarray:
        """Materialize the on-device logits buffer (horizon → per-token
        mode transition) on the host."""
        return self._host(self._dev_logits).astype(np.float32)

    def _dev_sync(self, rows, host_logits) -> None:
        """Ensure the device logits buffer exists and refresh `rows` from
        host values (per-token → horizon mode transition)."""
        if self._dev_logits is None:
            self._dev_logits = torch.zeros(
                (self.B, self.model.config.n_vocab), dtype=torch.float32,
                device=self.device)
        if len(rows):
            self._dev_logits[self._put(np.asarray(rows, np.int64))] = \
                self._put(np.asarray(host_logits, np.float32))

    def _dev_horizon(self, start_pos, forced, cids, H: int, table=None):
        """H decode steps on the device (ops/generate_loop.scheduler_loop)."""
        from ..ops.generate_loop import scheduler_loop

        if table is not None:
            self.cache.with_table(table)
        toks, tids, tvals, cvals, self._dev_logits, self.cache = \
            scheduler_loop(
                self._st, self.model.weights, self.cache,
                self._dev_logits, self._put(start_pos),
                self._put(forced), self._put(cids), H, graphs=self._graphs)
        return (self._host(toks), self._host(tids),
                self._host(tvals).astype(np.float32),
                self._host(cvals).astype(np.float32))

    def _dev_release(self, row: int, pages=None, table=None) -> None:
        """Blank a freed row's cache positions (and, paged, install the
        post-release page table) so the next owner starts masked-out."""
        if self.paged:
            if pages is not None and len(pages):
                self.cache.positions[self._put(np.asarray(pages, np.int64))] = -1
            self.cache.with_table(table)
        else:
            self.cache.positions[row] = -1

    # -- public API ----------------------------------------------------------

    def submit(self, request: GenRequest) -> None:
        request._t_submit = time.monotonic()
        self._queue.put(request)

    @staticmethod
    def cancel(request: GenRequest) -> None:
        """Abort a submitted request (thread-safe; client-disconnect path).
        It finishes early — on_done still fires, with whatever was
        generated — and its row/pages are recycled on the next iteration."""
        request._cancel.set()

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, name="blama-scheduler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=30)

    def run_until_idle(self) -> None:
        """Synchronous drain (for tests and batch jobs)."""
        while not self._queue.empty() or self._head is not None or any(
                s.request or s.verify for s in self._slots):
            self._iteration()

    # -- engine --------------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            if self._queue.empty() and self._head is None and not any(
                    s.request or s.verify for s in self._slots):
                try:
                    with self.metrics.timer("idle"):
                        req = self._queue.get(timeout=0.05)
                    self._queue.put(req)
                except queue.Empty:
                    continue
            self._iteration()

    def _next_request(self):
        """FIFO head with paged admission control: a request that does not
        fit the free pool waits at the head (no overtaking, so admission
        order — and therefore physical placement — is deterministic).
        Requests larger than the whole pool are rejected outright."""
        if self._head is None:
            try:
                self._head = self._queue.get_nowait()
            except queue.Empty:
                return None
        if self.paged:
            req = self._head
            # a resumed (preempted) request re-prefills prompt+generated, so
            # admission must gate on the RESUME length, not the original
            # prompt (else allocate_slots can fail after can_admit passed)
            res = getattr(req, "_resume", None)
            n_prompt = max(1, len(res[0]) if res is not None
                           else len(req.prompt or []))
            if self._alloc.pages_for(n_prompt) + 1 > self._alloc.n_pages:
                self._head = None
                from ..utils.logging import scope_logger

                scope_logger("scheduler").error(
                    "request prompt (%d tokens) exceeds the KV pool; rejected",
                    n_prompt)
                if isinstance(req, VerifyRequest):
                    if req.on_done:
                        req.on_done(0.0)
                else:
                    req.finish_reason = "rejected"
                    if req.on_done:
                        req.on_done([])
                return self._next_request()
            if not self._alloc.can_admit(n_prompt):
                return None  # wait for pages to free up
        req, self._head = self._head, None
        return req

    def _admit(self) -> None:
        """Admit as many queued requests as there are free rows, then prefill
        ALL of them together (one shared chunked [B, T] dispatch sequence
        instead of one full pass per admission)."""
        jobs: list[tuple[int, list[int], np.ndarray | None]] = []
        for b, slot in enumerate(self._slots):
            if slot.request is not None or slot.verify is not None:
                continue
            req = self._next_request()
            if req is None:
                break
            self.metrics.record("queue_wait", time.monotonic() - req._t_submit)
            if isinstance(req, GenRequest) and req._cancel.is_set():
                req.finish_reason = "cancelled"
                if req.on_done:
                    req.on_done([])
                continue  # this slot stays free for the next iteration
            slot.num_past = 0
            slot.generated = []
            slot.pending_token = -1
            slot.last_logits = None
            slot.verify_idx = 0
            accept = True
            if isinstance(req, VerifyRequest):
                from ..runtime.verify import MetricsAggregator

                slot.verify = req
                slot.sampler = None
                slot.aggregator = MetricsAggregator()
                tokens = list(req.prompt or [self.model.vocab.bos()])
            elif req._resume is not None:
                # preempted request returns: re-prefill prompt + generated
                # with its ORIGINAL sampler state (tokens already accepted)
                tokens, sampler, generated = req._resume
                req._resume = None
                slot.request = req
                slot.sampler = sampler
                slot.generated = generated
                accept = False
            else:
                slot.request = req
                slot.sampler = Sampler(self.model.vocab, req.sampler_params)
                tokens = list(req.prompt or [self.model.vocab.bos()])
            flat = None
            if self.paged:
                # allocate at admission time so the next _next_request's
                # can_admit sees the reduced pool (the admission-control
                # invariant the per-request prefill preserved implicitly)
                flat = self._alloc.allocate_slots(b, len(tokens))
                assert flat is not None, "admission guaranteed the prompt's pages"
            jobs.append((b, tokens, flat, accept))
        if jobs:
            self._prefill_rows(jobs)

    def _prefill_rows(self, jobs: list[tuple[int, list[int], np.ndarray | None, bool]]) -> None:
        """Prefill newly admitted rows TOGETHER in chunked [B, T] dispatches.

        Every row advances through the same passes (concurrent admissions
        share the batch FLOPs), and each row's last-token logits come from
        its final chunk via the per-row logits index (reference C++ batch
        semantics: per-token logit-request masks, Session.cpp:380-392)."""
        with self.metrics.timer("prefill"):
            first_table = self._alloc.tables if self.paged else None
            chunk = 256
            todo = {b: (tokens, flat) for b, tokens, flat, _ in jobs}
            accept = {b: a for b, _, _, a in jobs}
            off = {b: 0 for b in todo}
            while todo:
                allparts = {b: todo[b][0][off[b]: off[b] + chunk] for b in todo}
                # rows sharing a dispatch must share the per-row bucketed T a
                # solo prefill would use — a row's padded shape (and thus its
                # KV numerics at the ULP level) must not depend on its batch
                # neighbors' prompt lengths (batch invariance,
                # test_batched_verify_batch_invariant)
                bucket = {b: max(8, 1 << (len(p) - 1).bit_length())
                          for b, p in allparts.items()}
                T = min(bucket.values())
                parts = {b: p for b, p in allparts.items() if bucket[b] == T}
                toks = np.zeros((self.B, T), np.int32)
                pos = np.zeros((self.B, T), np.int32)
                sl = np.full((self.B, T), self._pad_slot, np.int32)  # drop everywhere
                li = np.zeros((self.B,), np.int32)
                for b, part in parts.items():
                    slot = self._slots[b]
                    n = len(part)
                    toks[b, :n] = part
                    pos[b, :n] = np.arange(slot.num_past, slot.num_past + n)
                    if self.paged:
                        sl[b, :n] = todo[b][1][off[b]: off[b] + n]
                    else:
                        sl[b, :n] = np.arange(slot.num_past, slot.num_past + n)
                    li[b] = n - 1
                finishing = [b for b, part in parts.items()
                             if off[b] + len(part) >= len(todo[b][0])]
                logits = self._dev_step(
                    toks, pos, sl, li, table=first_table,
                    capture=finishing if self.horizon > 1 else (),
                    pull=bool(finishing))
                first_table = None
                for b, part in parts.items():
                    slot = self._slots[b]
                    slot.num_past += len(part)
                    off[b] += len(part)
                    if slot.sampler is not None and accept[b]:
                        for t in part:
                            slot.sampler.accept(t, False)
                    if off[b] >= len(todo[b][0]):
                        # this chunk ended the row's prompt: its last-token
                        # logits are this dispatch's row (per-row index)
                        if self.horizon > 1:
                            self._stale_dev.discard(b)
                        slot.last_logits = logits[b].astype(np.float32)
                        self._stale_host.discard(b)
                        del todo[b]
        self.metrics.tokens_prefilled += sum(len(t) for _, t, _, _ in jobs)

    @staticmethod
    def _device_greedy(sp: SamplerParams) -> bool:
        """Whether a row's sampling reduces to device-side argmax: greedy
        temperature with every host-only transform neutral."""
        rp = sp.repetition_penalty
        return (sp.temp <= 0.0
                and (rp.num_tokens == 0 or (rp.repeat == 1.0 and rp.freq == 0.0
                                            and rp.present == 0.0))
                and sp.mirostat.ver == 0
                and not sp.grammar
                and not sp.logit_bias)

    def _iteration(self) -> None:
        """One scheduler iteration. Its timers nest: `iteration` spans
        `prefill` (admission), `sample` (host sampling of the per-token
        path) and `decode_step` (one per-token step) or `decode_horizon`
        (one device loop of `horizon` steps); what remains of it is host
        bookkeeping (planning, callbacks, releases). `idle` (waiting for
        work) lies outside, and `queue_wait` is per request, submission to
        admission."""
        with self.metrics.timer("iteration"):
            self._iterate()

    def _iterate(self) -> None:
        self._admit()
        active = [b for b, s in enumerate(self._slots)
                  if s.request is not None or s.verify is not None]
        if not active:
            return
        if self.horizon > 1 and all(
                s.verify is not None or self._device_greedy(s.request.sampler_params)
                for s in (self._slots[b] for b in active)):
            self._horizon_iteration(active)
            return
        if self._stale_host:
            # rows last decoded by the horizon loop: refresh their host
            # logits before host-side sampling resumes (mode transition)
            host = self._dev_pull()
            for b in list(self._stale_host):
                if self._slots[b].request is not None or self._slots[b].verify is not None:
                    self._slots[b].last_logits = host[b]
            self._stale_host.clear()

        # next token per active row: sampled for generation rows (host,
        # per-request sampler state), teacher-forced for verification rows
        with self.metrics.timer("sample"):
            self._pick_tokens(active)

        # batched decode of all pending tokens
        with self.metrics.timer("decode_step"):
            toks = np.zeros((self.B, 1), np.int32)
            pos = np.zeros((self.B, 1), np.int32)
            sl = np.full((self.B, 1), self._pad_slot, np.int32)
            for b in active:
                slot = self._slots[b]
                if slot.pending_token >= 0:
                    if self.paged:
                        flat = self._alloc.allocate_slots(b, 1)
                        if flat is None:
                            # pool dry (class docstring policy): preempt the
                            # gen row (requeue + re-prefill later) or finish
                            # it early as "evicted" when it can't fit solo;
                            # verify rows always finish with their partial
                            # score
                            if slot.request is not None:
                                slot.pending_token = -2  # preempt below
                            else:
                                slot.pending_token = -1
                            continue
                        sl[b, 0] = flat[0]
                    else:
                        sl[b, 0] = slot.num_past
                    toks[b, 0] = slot.pending_token
                    pos[b, 0] = slot.num_past
            logits = self._dev_step(
                toks, pos, sl, np.zeros((self.B,), np.int32),
                table=self._alloc.tables if self.paged else None)
            logits_host = logits.astype(np.float32)
            if self.horizon > 1:
                self._stale_dev.update(
                    b for b in active if self._slots[b].pending_token >= 0)

        for b in active:
            slot = self._slots[b]
            if slot.pending_token == -2:
                self._preempt_or_evict(b)
                continue
            if slot.pending_token < 0:
                self._finish(b)
                continue
            if slot.verify is not None:
                self._verify_step(b, logits_host[b])
                continue
            slot.sampler.accept(slot.pending_token, True)
            slot.num_past += 1
            slot.last_logits = logits_host[b]
            self.metrics.tokens_decoded += 1
            top = self._top10(slot.last_logits)
            pred = TokenPrediction(slot.pending_token, top)
            slot.generated.append(pred)
            if slot.request.on_token:
                slot.request.on_token(pred)
            if len(slot.generated) >= slot.request.max_tokens or slot.num_past >= self.S - 1:
                slot.request.finish_reason = "length"
                self._finish(b)

    def _pick_tokens(self, active: list[int]) -> None:
        """Set each active row's `pending_token` for a per-token step
        (-1: the row finishes without decoding)."""
        for b in active:
            slot = self._slots[b]
            if slot.request is not None and slot.request._cancel.is_set():
                slot.request.finish_reason = "cancelled"
                slot.pending_token = -1  # finish early; row freed below
                continue
            if slot.verify is not None:
                if slot.verify_idx >= len(slot.verify.predictions) \
                        or slot.num_past >= self.S - 1:
                    slot.pending_token = -1
                else:
                    slot.pending_token = slot.verify.predictions[slot.verify_idx].token
                continue
            tok = slot.sampler.sample(slot.last_logits)
            if self.model.vocab.is_eog(tok) or len(slot.generated) >= slot.request.max_tokens - 1 or slot.num_past >= self.S - 1:
                # finish: EOG is not decoded (Session semantics)
                if not self.model.vocab.is_eog(tok):
                    slot.pending_token = tok
                else:
                    slot.request.finish_reason = "stop"
                    slot.pending_token = -1
            else:
                slot.pending_token = tok

    def _horizon_iteration(self, active: list[int]) -> None:
        """Up to `horizon` decode steps in ONE device dispatch (greedy +
        verify rows; ops/generate_loop.scheduler_loop). Only small per-step
        outputs (tokens, top-10, claimed-id values) cross the host boundary;
        the [B, V] logits stay on device between horizons."""
        from ..runtime.verify import LogitComparer

        H = self.horizon
        sync_rows = [b for b in sorted(self._stale_dev)  # per-token -> horizon
                     if self._slots[b].last_logits is not None]
        self._dev_sync(sync_rows,
                       np.stack([self._slots[b].last_logits
                                 for b in sync_rows])
                       if sync_rows else
                       np.zeros((0, self.model.config.n_vocab), np.float32))
        self._stale_dev.clear()

        # plan step counts first; under paged KV clamp by what the pool can
        # actually back and pre-allocate the horizon's slots (the device
        # loop derives flat slots from the page table per step). Rows in
        # the same plan contend for the same free pages, so allocation is
        # committed row-by-row HERE and the remaining budget threads through
        # the loop — max_extend against the global free count alone would
        # let two rows at page boundaries both claim the last free page.
        plan: dict[int, int] = {}  # row -> planned step count
        starved: list[int] = []
        budget = self._alloc.free_pages if self.paged else 0
        for b in active:
            slot = self._slots[b]
            cap = self.S - 1 - slot.num_past
            if slot.verify is not None:
                n = min(H, max(cap, 0),
                        len(slot.verify.predictions) - slot.verify_idx)
            else:
                n = min(slot.request.max_tokens - len(slot.generated), H,
                        max(cap, 0))
            if self.paged and n > 0:
                fit = self._alloc.max_extend(b, n, free_budget=budget)
                if fit <= 0:
                    # pool dry before this row could take a single step
                    # (class docstring policy: preempt or evict)
                    starved.append(b)
                    continue
                n = fit
                before = self._alloc.free_pages
                if self._alloc.allocate_slots(b, n) is None:
                    starved.append(b)  # defensive; budget bounds the alloc
                    continue
                budget -= before - self._alloc.free_pages
            plan[b] = n
        for b in starved:
            if self._slots[b].request is not None:
                self._preempt_or_evict(b)
            else:
                self._finish(b)
        active = [b for b in active if b not in starved]
        if not active:
            return

        forced = np.full((self.B, H), -2, np.int32)
        cids = np.zeros((self.B, H, 10), np.int32)
        start_pos = np.zeros(self.B, np.int32)
        for b in active:
            slot = self._slots[b]
            start_pos[b] = slot.num_past
            if slot.verify is not None:
                rem = slot.verify.predictions[
                    slot.verify_idx: slot.verify_idx + plan[b]]
                for i, pred in enumerate(rem):
                    forced[b, i] = pred.token
                    ids = sorted({td.token for td in pred.logits})
                    cids[b, i, : len(ids)] = ids
            else:
                forced[b, : plan[b]] = -1  # device argmax
        with self.metrics.timer("decode_horizon"):
            toks, tids, tvals, cvals = self._dev_horizon(
                start_pos, forced, cids, H,
                table=self._alloc.tables if self.paged else None)

        for b in active:
            slot = self._slots[b]
            self._stale_host.add(b)
            if slot.verify is not None:
                for i in range(plan[b]):
                    claimed = slot.verify.predictions[slot.verify_idx]
                    ids = np.array(sorted({td.token for td in claimed.logits}),
                                   np.int64)
                    vals = cvals[b, i, : len(ids)]
                    order = np.lexsort((ids, -vals))
                    replayed = [TokenData(int(ids[j]), float(vals[j]))
                                for j in order]
                    slot.aggregator.push_and_verify(
                        LogitComparer.compare(claimed.logits, replayed))
                    slot.generated.append(
                        TokenPrediction(claimed.token, replayed))
                    slot.verify_idx += 1
                    slot.num_past += 1
                    self.metrics.tokens_decoded += 1
                if (slot.verify_idx >= len(slot.verify.predictions)
                        or slot.num_past >= self.S - 1):
                    self._finish(b)
                continue
            done = plan[b] == 0
            reason = "length" if done else None
            for i in range(plan[b]):
                tok = int(toks[b, i])
                if self.model.vocab.is_eog(tok):
                    done, reason = True, "stop"  # EOG is not accepted (Session semantics)
                    break
                if slot.request._cancel.is_set():
                    done, reason = True, "cancelled"
                    break
                slot.sampler.accept(tok, True)
                slot.num_past += 1
                self.metrics.tokens_decoded += 1
                top = [TokenData(int(tids[b, i, j]), float(tvals[b, i, j]))
                       for j in range(10)]
                pred = TokenPrediction(tok, top)
                slot.generated.append(pred)
                if slot.request.on_token:
                    slot.request.on_token(pred)
                if (len(slot.generated) >= slot.request.max_tokens
                        or slot.num_past >= self.S - 1):
                    done, reason = True, "length"
                    break
            if done:
                slot.request.finish_reason = reason
                self._finish(b)

    def _verify_step(self, row: int, lg: np.ndarray) -> None:
        """One teacher-forced replay step: recompute the claimed token set's
        logits (Session.get_logits_for semantics, Session.cpp:263-282) and
        push the comparison into the row's aggregator."""
        from ..runtime.verify import LogitComparer

        slot = self._slots[row]
        claimed = slot.verify.predictions[slot.verify_idx]
        slot.num_past += 1
        slot.last_logits = lg
        self.metrics.tokens_decoded += 1
        ids = np.array(sorted({td.token for td in claimed.logits}), np.int64)
        vals = lg[ids]
        order = np.lexsort((ids, -vals))
        replayed = [TokenData(int(ids[i]), float(vals[i])) for i in order]
        slot.aggregator.push_and_verify(
            LogitComparer.compare(claimed.logits, replayed))
        slot.generated.append(TokenPrediction(claimed.token, replayed))
        slot.verify_idx += 1
        if slot.verify_idx >= len(slot.verify.predictions):
            self._finish(row)

    def _preempt_or_evict(self, b: int) -> None:
        """Pool-dry policy for a generation row: requeue (preempt) when the
        request still fits the pool solo, else finish early as "evicted"."""
        slot = self._slots[b]
        req = slot.request
        resume_tokens = list(req.prompt or [self.model.vocab.bos()]) + [
            p.token for p in slot.generated]
        if req._cancel.is_set():
            req.finish_reason = "cancelled"
            self._finish(b)
            return
        if (self._alloc.pages_for(len(resume_tokens) + 1) + 1
                > self._alloc.n_pages):
            req.finish_reason = "evicted"
            self._finish(b)
            return
        req._resume = (resume_tokens, slot.sampler, slot.generated)
        req.preempted_at.append(len(slot.generated))
        # release the row WITHOUT firing callbacks, then requeue (FIFO back:
        # waiting admissions go first — their pages were the contention)
        slot.request = None
        slot.sampler = None
        slot.generated = []
        slot.last_logits = None
        self._release_row(b)
        self.submit(req)

    @staticmethod
    def _top10(lg: np.ndarray) -> list[TokenData]:
        idx = np.argpartition(-lg, 10)[:10]
        idx = idx[np.lexsort((idx, -lg[idx]))]
        return [TokenData(int(i), float(lg[i])) for i in idx]

    def _release_row(self, row: int) -> None:
        """Free a row's cache state (paged: release the pages and blank
        their pool positions so the next owner starts masked-out)."""
        if self.paged:
            pages = self._alloc.free_row(row)
            self._dev_release(row, pages=pages, table=self._alloc.tables)
        else:
            self._dev_release(row)

    def _finish(self, row: int) -> None:
        slot = self._slots[row]
        req = slot.request
        ver = slot.verify
        agg = slot.aggregator
        generated = slot.generated
        self._release_row(row)
        slot.request = None
        slot.verify = None
        slot.sampler = None
        slot.aggregator = None
        slot.generated = []
        slot.last_logits = None
        if ver is not None:
            if ver.on_replayed:
                ver.on_replayed(generated)
            if ver.on_done:
                score = agg.push_and_verify([]) if agg and agg.metrics else 0.0
                ver.on_done(score)
            return
        if req:
            if req.finish_reason is None:
                req.finish_reason = "stop"
            if req.on_done:
                req.on_done(generated)
