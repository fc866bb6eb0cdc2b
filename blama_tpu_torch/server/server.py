"""Server facade: async API over a serialized inference job queue.

Counterpart of blama_tpu/server/server.py, the mirror of the reference C++
bl::llama::server::Server (server/Server.{hpp,cpp}): owns a shared Model +
one Instance (warmed up at construction), runs every operation on a single
worker thread — the serialized job queue of Server.cpp:27-36 — and completes
each request through a callback. The four operations are completeText,
chatComplete, verify, chatVerify (Server.cpp:45-210).

This single-instance queue is the deterministic verification mode; the
continuous-batching scheduler (server/scheduler.py) is the throughput mode.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import Callable

from ..runtime.chat import ChatFormat, ChatMsg
from ..runtime.instance import Instance, InstanceInitParams
from ..runtime.model import Model
from ..runtime.session import CompleteParams, SessionInitParams
from ..runtime.token_data import TokenData as _TD, TokenPrediction
from ..runtime.verify import LogitComparer, MetricsAggregator
from ..utils.metrics import Metrics


@dataclass
class CompleteRequestParams:
    """Server.hpp:25-32."""

    prompt: str = ""
    max_tokens: int = 0
    seed: int = 0
    suffix: str = ""
    temperature: float = 0.8
    top_p: float = 0.95


@dataclass
class ChatMessage:
    role: str = ""
    content: str = ""


@dataclass
class ChatCompleteRequestParams:
    """Server.hpp:34-44."""

    messages: list[ChatMessage] = field(default_factory=list)
    max_tokens: int = 0
    seed: int = 0
    temperature: float = 0.8
    top_p: float = 0.95


@dataclass
class LogitData:
    token_id: int = 0
    logit: float = 0.0


@dataclass
class TokenData:
    """Wire token record (Server.hpp:46-54)."""

    token_str: str = ""
    token_id: int = 0
    logits: list[LogitData] = field(default_factory=list)


class CompleteResponse(list):
    """list[TokenData] wire response, plus an optional `finish_reason`
    extension ("stop" | "length" | "evicted" | "cancelled" | "rejected")
    set by the scheduler path so clients can distinguish EOG from pool
    eviction/truncation (the reference throws instead,
    Session.cpp:331-333). Plain lists remain accepted everywhere."""

    finish_reason: str | None = None


class Facade:
    """What the solo and the scheduler-backed server share: the model, the
    metrics registry and the conversions between the wire records and the
    runtime's token predictions. The HTTP front end talks to either through
    complete_text / chat_complete / verify / chat_verify, metrics_snapshot
    and close."""

    def __init__(self, model: Model):
        self._model = model
        self.metrics = Metrics()

    def metrics_snapshot(self) -> dict:
        return self.metrics.snapshot()

    def _predictions_to_response(self, preds: list[TokenPrediction]) -> CompleteResponse:
        vocab = self._model.vocab
        return CompleteResponse(
            TokenData(
                token_str=vocab.token_to_string(p.token),
                token_id=p.token,
                logits=[LogitData(td.token, td.logit) for td in p.logits],
            )
            for p in preds
        )

    def _response_to_predictions(self, resp: CompleteResponse) -> list[TokenPrediction]:
        return [
            TokenPrediction(t.token_id, [_TD(l.token_id, l.logit) for l in t.logits])
            for t in resp
        ]

    def _format_chat(self, params: ChatCompleteRequestParams) -> str:
        chat_params = ChatFormat.get_chat_params(self._model)
        fmt = ChatFormat(chat_params)
        msgs = [ChatMsg(m.role, m.content) for m in params.messages]
        return fmt.format_chat(msgs, True)


class Server(Facade):
    def __init__(self, model: Model, instance_params: InstanceInitParams | None = None):
        super().__init__(model)
        self._instance = Instance(model, instance_params or InstanceInitParams())
        self._instance.warmup()
        self._queue: queue.Queue[Callable[[], None] | None] = queue.Queue()
        self._worker = threading.Thread(target=self._run, name="blama-inference", daemon=True)
        self._worker.start()

    def _run(self) -> None:
        while True:
            job = self._queue.get()
            if job is None:
                return
            try:
                job()
            except Exception:
                import logging

                logging.getLogger("blama_tpu_torch").exception("inference job failed")

    def close(self) -> None:
        self._queue.put(None)
        self._worker.join(timeout=30)

    # -- internals -----------------------------------------------------------

    def _session_params(self, p) -> SessionInitParams:
        return SessionInitParams(seed=p.seed, temperature=p.temperature, top_p=p.top_p)

    def _run_verify(self, session, resp: CompleteResponse) -> float:
        orig = self._response_to_predictions(resp)
        replayed = session.fill_ctx(orig)
        agg = MetricsAggregator()
        score = 0.0
        for o, r in zip(orig, replayed):
            m = LogitComparer.compare(o.logits, r.logits)
            score = agg.push_and_verify(m)
        return score

    # -- public async API (Server.hpp:58-64) ----------------------------------

    def complete_text(self, params: CompleteRequestParams, cb: Callable[[CompleteResponse], None]) -> None:
        def job():
            session = self._instance.start_session(self._session_params(params))
            try:
                tokens = self._model.vocab.tokenize(params.prompt, True, True)
                with self.metrics.timer("prefill"):
                    session.set_initial_prompt(tokens)
                self.metrics.tokens_prefilled += len(tokens)
                suffix = (
                    self._model.vocab.tokenize(params.suffix, False, True)
                    if params.suffix else []
                )
                with self.metrics.timer("decode_step"):
                    preds = session.complete(
                        CompleteParams(suffix=suffix, max_tokens=params.max_tokens or (1 << 30))
                    )
                self.metrics.tokens_decoded += len(preds)
                cb(self._predictions_to_response(preds))
            finally:
                self._instance.stop_session()

        self._queue.put(job)

    def chat_complete(self, params: ChatCompleteRequestParams, cb: Callable[[CompleteResponse], None]) -> None:
        def job():
            session = self._instance.start_session(self._session_params(params))
            try:
                fmt = self._format_chat(params)
                session.set_initial_prompt(self._model.vocab.tokenize(fmt, True, True))
                preds = session.complete(CompleteParams(max_tokens=params.max_tokens or (1 << 30)))
                cb(self._predictions_to_response(preds))
            finally:
                self._instance.stop_session()

        self._queue.put(job)

    def verify(self, req: CompleteRequestParams, resp: CompleteResponse, cb: Callable[[float], None]) -> None:
        def job():
            session = self._instance.start_session(self._session_params(req))
            try:
                session.set_initial_prompt(self._model.vocab.tokenize(req.prompt, True, True))
                cb(self._run_verify(session, resp))
            finally:
                self._instance.stop_session()

        self._queue.put(job)

    def chat_verify(self, req: ChatCompleteRequestParams, resp: CompleteResponse, cb: Callable[[float], None]) -> None:
        def job():
            session = self._instance.start_session(self._session_params(req))
            try:
                fmt = self._format_chat(req)
                session.set_initial_prompt(self._model.vocab.tokenize(fmt, True, True))
                cb(self._run_verify(session, resp))
            finally:
                self._instance.stop_session()

        self._queue.put(job)
