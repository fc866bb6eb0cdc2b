"""Scheduler-backed Server: continuous batching behind the same async API.

Counterpart of blama_tpu/server/scheduler_server.py. Opt-in throughput mode
(BLAMA_SCHEDULER=<max_batch> on the HTTP server): /complete and
/chat/completions run on the ContinuousBatchingScheduler (many requests
share batched decode steps, per-request seeds), and the verification
endpoints run as teacher-forced batch rows of the same scheduler (rows are
batch-invariant, tested in tests/test_torch_scheduler.py).
"""

from __future__ import annotations

from typing import Callable

from ..runtime.instance import InstanceInitParams
from ..runtime.model import Model
from ..runtime.sampler import SamplerParams
from .scheduler import ContinuousBatchingScheduler, GenRequest
from .server import (
    ChatCompleteRequestParams,
    CompleteRequestParams,
    CompleteResponse,
    Facade,
)


class SchedulerServer(Facade):
    """Server facade whose endpoints all run on the batching scheduler (no
    solo Instance, so no second set of KV rows)."""

    def __init__(self, model: Model, instance_params: InstanceInitParams | None = None,
                 max_batch: int = 8, paged: bool = False, n_pages: int = 0,
                 horizon: int = 0, multihost: bool = False):
        if multihost:
            raise NotImplementedError(
                "multi-process serving is not ported "
                "(ROADMAP.md §1 item 13, multi-GPU)")
        super().__init__(model)
        ctx = (instance_params.ctx_size if instance_params else 0) or model.config.n_ctx_train
        self.scheduler = ContinuousBatchingScheduler(
            model, max_batch=max_batch, ctx_size=ctx, paged=paged,
            n_pages=n_pages, horizon=horizon)
        self.scheduler.start()

    def close(self) -> None:
        self.scheduler.stop()

    def metrics_snapshot(self) -> dict:
        snap = super().metrics_snapshot()
        snap["scheduler"] = self.scheduler.metrics.snapshot()
        return snap

    # -- generation endpoints go through the scheduler -----------------------

    def _submit(self, prompt_tokens, params, cb: Callable[[CompleteResponse], None]) -> None:
        req = GenRequest(
            prompt=prompt_tokens,
            max_tokens=params.max_tokens or 128,
            sampler_params=SamplerParams(
                rng_seed=params.seed, temp=params.temperature, top_p=params.top_p
            ),
        )

        def done(preds):
            resp = self._predictions_to_response(preds)
            resp.finish_reason = req.finish_reason
            cb(resp)

        req.on_done = done
        self.scheduler.submit(req)

    def complete_text(self, params: CompleteRequestParams, cb) -> None:
        tokens = self._model.vocab.tokenize(params.prompt, True, True)
        self._submit(tokens, params, cb)

    def chat_complete(self, params: ChatCompleteRequestParams, cb) -> None:
        tokens = self._model.vocab.tokenize(self._format_chat(params), True, True)
        self._submit(tokens, params, cb)

    # -- verification runs as teacher-forced batch rows ------------------------

    def _submit_verify(self, prompt_tokens, resp: CompleteResponse, cb) -> None:
        from .scheduler import VerifyRequest

        self.scheduler.submit(VerifyRequest(
            prompt=prompt_tokens,
            predictions=self._response_to_predictions(resp),
            on_done=cb,
        ))

    def verify(self, req: CompleteRequestParams, resp: CompleteResponse, cb) -> None:
        tokens = self._model.vocab.tokenize(req.prompt, True, True)
        self._submit_verify(tokens, resp, cb)

    def chat_verify(self, req: ChatCompleteRequestParams, resp: CompleteResponse, cb) -> None:
        fmt = self._format_chat(req)
        tokens = self._model.vocab.tokenize(fmt, True, True)
        self._submit_verify(tokens, resp, cb)
