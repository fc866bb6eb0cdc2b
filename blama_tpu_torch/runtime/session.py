"""Session: the decode state machine with logit capture and replay.

Re-implements the reference Session semantics (Session.{hpp,cpp}) on the
port's runtime; a copy of the JAX package's host logic over the port's ops:

  * phases Initial → Generating → Streaming with exact-message errors
    (Session.cpp:66-67,110-111,170-172 — pinned by t-integration.cpp:137-158)
  * maxTokens = ctx_len − 4 (Session.cpp:58)
  * setInitialPrompt: empty→BOS, too-long check
    (Session.cpp:65-107)
  * pushPrompt: sampler reset + optional BOS prefix + FIM pre/suf/mid infill
    assembly (Session.cpp:109-167)
  * getToken: sample → EOG→invalid → top-10 logit capture; the sampled token
    is decoded lazily on the next call (deferred decode, Session.cpp:169-190,
    395-401)
  * complete / completeStream pull-generator with abort (Session.cpp:192-229,
    407-432)
  * fillCtx verification replay: teacher-force each claimed token, recompute
    logits restricted to the claimed token set (Session.cpp:231-244,263-282)
  * context-shift "infinite context" and Self-Extend grouped attention as
    pure KV position edits (Session.cpp:324-368 → ops/kv_cache.py)
  * state save/restore (Session.cpp:284-310); like the reference, the sampler
    RNG state is NOT part of the snapshot (documented quirk pinned by
    t-integration.cpp:378-381)
"""

from __future__ import annotations

import enum
import io
from dataclasses import dataclass, field

import numpy as np

from .sampler import Sampler, SamplerParams
from .token_data import TOKEN_INVALID, TokenData, TokenPrediction


# the architectures whose sessions take the device loops, as the reference
# gates them (blama_tpu/runtime/session.py:264, :363); gemma, gemma2, phi3
# and gpt2 take the step-by-step path there, so they do here (a mixtral
# file's architecture is llama)
FAST_PATH_ARCHS = ("llama", "mistral", "qwen2")


class Phase(enum.Enum):
    INITIAL = 0
    GENERATING = 1
    STREAMING = 2


@dataclass
class SessionInitParams:
    """Reference: Session::InitParams (Session.hpp:31-43)."""

    ga_factor: int = 1        # group-attention factor
    ga_width: int = 512       # group-attention width (multiple of factor)
    infinite_context: bool = True
    seed: int = 0
    grammar: str = ""
    temperature: float = 0.8
    top_p: float = 0.95


@dataclass
class CompleteParams:
    prompt: list[int] = field(default_factory=list)
    suffix: list[int] = field(default_factory=list)
    max_tokens: int = 1 << 30


class StreamStatus(enum.Enum):
    IN_PROGRESS = 0
    COMPLETED = 1
    ABORTED = 2


class StreamGenerator:
    """Pull-based streaming generator (Session.hpp:59-85, Session.cpp:407-432)."""

    def __init__(self, session: "Session", params: CompleteParams):
        self._session = session
        self._params = params
        self._gen = 0
        self.status = StreamStatus.IN_PROGRESS

    def complete(self) -> TokenPrediction:
        s = self._session
        if s._phase != Phase.STREAMING or self.status != StreamStatus.IN_PROGRESS:
            return TokenPrediction(TOKEN_INVALID)
        p = s.get_token()
        if p.token == TOKEN_INVALID:
            s._phase = Phase.GENERATING
            self.status = StreamStatus.COMPLETED
            return p
        self._gen += 1
        if self._gen >= self._params.max_tokens:
            s._phase = Phase.GENERATING
            self.status = StreamStatus.COMPLETED
        return p

    def abort(self) -> None:
        self.status = StreamStatus.ABORTED

    def __iter__(self):
        while True:
            p = self.complete()
            if p.token == TOKEN_INVALID:
                return
            yield p


class Session:
    """One generation session bound to an Instance's KV cache."""

    def __init__(self, instance, params: SessionInitParams | None = None):
        self._instance = instance
        self._params = params or SessionInitParams()
        model = instance.model
        self._vocab = model.vocab
        self._sampler = Sampler(
            self._vocab,
            SamplerParams(
                rng_seed=self._params.seed,
                top_p=self._params.top_p,
                temp=self._params.temperature,
                grammar=self._params.grammar,
            ),
        )
        # clear KV (llama_kv_self_clear analog, Session.cpp:53)
        instance.clear_cache()
        self._phase = Phase.INITIAL
        self._max_tokens = instance.ctx_len - 4  # Session.cpp:58 (#16)
        self._num_keep = 0
        self._num_past = 0
        self._ga_index = 0
        self._curr_token = TOKEN_INVALID
        self._last_logits: np.ndarray | None = None  # full vocab, host f32

    # -- public API ----------------------------------------------------------

    def set_initial_prompt(self, prompt: list[int]) -> None:
        if self._phase != Phase.INITIAL:
            raise RuntimeError("Session already started")
        prompt = list(prompt)
        ctx_len = self._instance.ctx_len
        self._num_keep = min(len(prompt), self._max_tokens)
        if not prompt:
            prompt = [self._vocab.bos()]
        if len(prompt) > self._max_tokens:
            raise RuntimeError(
                f"Initial prompt too long. Got {len(prompt)} tokens, max: {ctx_len - 4}"
            )
        p = self._params
        if p.ga_factor != 1 and p.ga_width % p.ga_factor != 0:
            raise RuntimeError(
                f"Group-attention width {p.ga_width} must be a multiple of "
                f"group-attention factor {p.ga_factor}"
            )
        self._do_decode(prompt, generated=False)
        self._phase = Phase.GENERATING

    def push_prompt(self, prompt: list[int], postfix: list[int] | None = None) -> None:
        if self._phase not in (Phase.GENERATING, Phase.STREAMING):
            raise RuntimeError("Session hasn't started yet")
        self._flush_pending()
        postfix = postfix or []
        if not prompt and not postfix:
            raise RuntimeError("Prompt and postfix are empty")

        model = self._instance.model
        # reset sampling so previous inputs don't affect the generation
        # (Session.cpp:123); NB resets RNG too, mirroring llama.cpp chain reset
        self._sampler.reset(reseed=True)

        tokens: list[int] = []
        if model.prefix_inputs_with_bos():
            tokens.append(self._vocab.bos())
        if postfix:
            fim_pre = self._vocab.fim_pre()
            if fim_pre >= 0:
                tokens.append(fim_pre)
        tokens.extend(prompt)
        if postfix:
            fim_suf = self._vocab.fim_suf()
            if fim_suf >= 0:
                tokens.append(fim_suf)
            tokens.extend(postfix)
            fim_mid = self._vocab.fim_mid()
            if fim_mid >= 0:
                tokens.append(fim_mid)

        if len(tokens) > self._max_tokens:
            raise RuntimeError(
                f"Prompt too long. Got {len(tokens)} tokens, max: {self._instance.ctx_len - 4}"
            )
        self._do_decode(tokens, generated=False)

    def get_token(self) -> TokenPrediction:
        if self._phase not in (Phase.GENERATING, Phase.STREAMING):
            raise RuntimeError("Session hasn't started yet")
        self._flush_pending()
        self._curr_token = self._sampler.sample(self._last_logits)
        if self._vocab.is_eog(self._curr_token):
            # don't decode EOG tokens in case the interaction continues
            self._curr_token = TOKEN_INVALID
        return TokenPrediction(self._curr_token, self.get_logits_top(10))

    def complete(self, params: CompleteParams | None = None) -> list[TokenPrediction]:
        if self._phase != Phase.GENERATING:
            raise RuntimeError("Session hasn't started yet")
        params = params or CompleteParams()
        self._flush_pending()
        if params.prompt or params.suffix:
            self.push_prompt(params.prompt, params.suffix)
        fast = self._try_fast_greedy(params.max_tokens)
        if fast is not None:
            return fast
        predictions = []
        for _ in range(params.max_tokens):
            p = self.get_token()
            if p.token == TOKEN_INVALID:
                break
            predictions.append(p)
        return predictions

    def _try_fast_greedy(self, max_tokens: int) -> list[TokenPrediction] | None:
        """Device-loop fast path: N greedy decode steps with the token choice
        kept on the device (ops.generate_loop.continue_greedy).

        Eligible only when it is provably equivalent to the step-by-step
        path: greedy sampling with no grammar/bias/penalties/mirostat, no
        pending context-shift, and a purely sequential slot layout. The
        sampled-token stream, captured top-10 logits, cache state, and
        post-call session state all match the slow path (tested).
        """
        inst = self._instance
        sp = self._sampler.params
        if not inst.params.fast_greedy:
            return None
        if not (
            sp.temp <= 0.0
            and not sp.grammar
            and not sp.logit_bias
            and sp.mirostat.ver == 0
            and sp.repetition_penalty.repeat == 1.0
            and sp.repetition_penalty.freq == 0.0
            and sp.repetition_penalty.present == 0.0
        ):
            return None
        if self._params.ga_factor != 1:
            return None
        n = min(max_tokens, self._max_tokens - self._num_past)
        if n <= 0 or self._num_past + n >= inst.ctx_len:
            return None  # would need context-shift: slow path handles it
        hp = inst.allocator.host_positions
        if not (hp[: self._num_past] == np.arange(self._num_past)).all() or (
            hp[self._num_past:] >= 0
        ).any():
            return None  # non-sequential layout (after shifts/edits)
        if inst.model.config.arch not in FAST_PATH_ARCHS:
            return None

        import torch

        from ..ops.generate_loop import continue_greedy, static_of

        # derive statics from the instance's step config so the device loop
        # uses the same attention engine (flash_attn) as the step path
        st = static_of(inst.step_config)
        tokens, all_logits, cache = continue_greedy(
            st, inst.model.weights, inst.cache,
            torch.from_numpy(self._last_logits[None, :]),
            torch.tensor([self._num_past], dtype=torch.int32), n, graphs=inst.graphs,
        )
        toks = tokens[0].cpu().numpy()
        lg = all_logits[0].float().cpu().numpy()  # [n, V]

        # truncate at the first EOG (reference never decodes EOG tokens)
        stop = n
        for i, t in enumerate(toks):
            if self._vocab.is_eog(int(t)):
                stop = i
                break

        predictions = []
        for i in range(stop):
            self._last_logits = lg[i]
            predictions.append(
                TokenPrediction(int(toks[i]), self.get_logits_top(10))
            )

        inst.cache = cache
        kept = stop
        # bookkeeping: the loop decoded tokens [0, stop); roll back any
        # decoded-beyond-EOG slots via a position edit (free in this design)
        new_past = self._num_past + kept
        inst.allocator.record(
            np.arange(self._num_past, new_past, dtype=np.int32),
            np.arange(self._num_past, new_past),
        )
        if kept < n:
            inst.kv_seq_rm(new_past, -1)
            # restore the logits state that produced the EOG sample
            self._last_logits = lg[kept - 1] if kept > 0 else self._last_logits
        self._num_past = new_past
        self._curr_token = TOKEN_INVALID
        return predictions

    def complete_stream(self, params: CompleteParams | None = None) -> StreamGenerator:
        if self._phase != Phase.GENERATING:
            raise RuntimeError("Session hasn't started yet")
        params = params or CompleteParams()
        self._flush_pending()
        if params.prompt or params.suffix:
            self.push_prompt(params.prompt, params.suffix)
        self._phase = Phase.STREAMING
        return StreamGenerator(self, params)

    def fill_ctx(self, tokens: list[TokenPrediction]) -> list[TokenPrediction]:
        """Teacher-forced replay for verification (Session.cpp:231-244).

        When the instance allows the device loop, the claimed tokens replay
        through `ops.generate_loop.teacher_forced`, which runs the same
        per-step forward as the fast-greedy prover, so its captured logits
        replay bit-exactly. The step-by-step path remains for edited layouts
        and is itself bit-exact vs step-path provers."""
        fast = self._try_fast_fill(tokens)
        if fast is not None:
            return fast
        result = []
        for tp in tokens:
            self.push_prompt([tp.token], [])
            result.append(TokenPrediction(tp.token, self.get_logits_for(tp.logits)))
        return result

    def _try_fast_fill(self, tokens: list["TokenPrediction"]) -> list[TokenPrediction] | None:
        """Device-loop teacher-forced replay (fill_ctx fast path).

        Sampling parameters are irrelevant (tokens are forced, logits only
        read), so eligibility is just: fast path enabled, sequential slot
        layout, and the claim fits in context."""
        inst = self._instance
        if not inst.params.fast_greedy or not tokens:
            return None
        if self._params.ga_factor != 1:
            return None
        n = len(tokens)
        if self._num_past + n >= inst.ctx_len or n > self._max_tokens:
            return None
        hp = inst.allocator.host_positions
        if not (hp[: self._num_past] == np.arange(self._num_past)).all() or (
            hp[self._num_past:] >= 0
        ).any():
            return None
        if inst.model.config.arch not in FAST_PATH_ARCHS:
            return None
        if inst.model.prefix_inputs_with_bos():
            return None  # slow path interleaves BOS before every claim token
        self._flush_pending()
        # mirror the slow path's sampler side effects (push_prompt resets the
        # chain per push — n resets ≡ one — then every token is accepted)
        self._sampler.reset(reseed=True)
        for tp in tokens:
            self._sampler.accept(tp.token, accept_grammar=False)

        import torch

        from ..ops.generate_loop import static_of, teacher_forced

        st = static_of(inst.step_config)
        claim = torch.tensor([[tp.token for tp in tokens]], dtype=torch.int32)
        all_logits, cache = teacher_forced(
            st, inst.model.weights, inst.cache, claim,
            torch.tensor([self._num_past], dtype=torch.int32), graphs=inst.graphs)
        lg = all_logits[0].float().cpu().numpy()  # [n, V]
        inst.cache = cache
        new_past = self._num_past + n
        inst.allocator.record(
            np.arange(self._num_past, new_past, dtype=np.int32),
            np.arange(self._num_past, new_past),
        )
        self._num_past = new_past
        self._curr_token = TOKEN_INVALID
        result = []
        for i, tp in enumerate(tokens):
            self._last_logits = lg[i]
            result.append(TokenPrediction(tp.token, self.get_logits_for(tp.logits)))
        return result

    # -- logit extraction ----------------------------------------------------

    def get_logits_top(self, top_k: int) -> list[TokenData]:
        if self._phase not in (Phase.GENERATING, Phase.STREAMING):
            raise RuntimeError("Session hasn't started yet")
        self._flush_pending()
        lg = self._last_logits
        # deterministic descending sort with index tiebreak
        idx = np.argpartition(-lg, top_k)[:top_k]
        idx = idx[np.lexsort((idx, -lg[idx]))]
        return [TokenData(int(i), float(lg[i])) for i in idx]

    def get_logits_for(self, tokens: list[TokenData]) -> list[TokenData]:
        if self._phase not in (Phase.GENERATING, Phase.STREAMING):
            raise RuntimeError("Session hasn't started yet")
        self._flush_pending()
        lg = self._last_logits
        ids = np.array(sorted({td.token for td in tokens}), dtype=np.int64)
        vals = lg[ids]
        order = np.lexsort((ids, -vals))
        return [TokenData(int(ids[i]), float(vals[i])) for i in order]

    # -- state save/restore --------------------------------------------------

    def get_state(self, include_sampler_rng: bool = False) -> bytes:
        """Serialize the session (KV + positions + bookkeeping).

        Like the reference, the sampler RNG state is NOT captured by default
        (llama_state_get_data excludes it — quirk pinned by
        t-integration.cpp:378-381: restore-from-middle is reproducible but
        differs from the original run). Pass include_sampler_rng=True for the
        fixed behavior: restored sessions then continue the original stream.
        """
        if self._phase != Phase.GENERATING:
            raise RuntimeError("Session hasn't started yet")
        self._flush_pending()
        buf = io.BytesIO()
        inst = self._instance
        k, v, pos, k_scale, v_scale = inst.cache_host()
        extra = {}
        if k_scale is not None:
            extra = {"k_scale": k_scale, "v_scale": v_scale}
        if include_sampler_rng:
            import pickle

            extra["sampler_rng"] = np.frombuffer(
                pickle.dumps((self._sampler._rng.bit_generator.state,
                              self._sampler._xtc_rng.bit_generator.state)),
                dtype=np.uint8,
            )
        np.savez(
            buf,
            k=k, v=v, pos=pos, **extra,
            host_positions=inst.allocator.host_positions,
            cursor=np.int64(inst.allocator._cursor),
            num_past=np.int64(self._num_past),
            num_keep=np.int64(self._num_keep),
            ga_index=np.int64(self._ga_index),
            last_logits=self._last_logits,
        )
        return buf.getvalue()

    def set_state(self, state: bytes) -> bool:
        if self._phase != Phase.INITIAL:
            raise RuntimeError("Session already started")
        data = np.load(io.BytesIO(state))
        inst = self._instance
        inst.restore_cache(
            data["k"], data["v"], data["pos"],
            data["k_scale"] if "k_scale" in data else None,
            data["v_scale"] if "v_scale" in data else None,
        )
        inst.allocator.host_positions[:] = data["host_positions"]
        inst.allocator._cursor = int(data["cursor"])
        self._num_past = int(data["num_past"])
        self._num_keep = int(data["num_keep"])
        self._ga_index = int(data["ga_index"])
        self._last_logits = data["last_logits"]
        if "sampler_rng" in data:
            import pickle

            rng_state, xtc_state = pickle.loads(data["sampler_rng"].tobytes())
            self._sampler._rng.bit_generator.state = rng_state
            self._sampler._xtc_rng.bit_generator.state = xtc_state
        self._phase = Phase.GENERATING
        return True

    def reset_sampler(self, params: SamplerParams) -> None:
        """Replace the sampler mid-session (Session.cpp:403-405)."""
        self._sampler = Sampler(self._vocab, params)

    # -- internals -----------------------------------------------------------

    def _flush_pending(self) -> None:
        if self._curr_token != TOKEN_INVALID:
            self._do_decode([self._curr_token], generated=True)
            self._curr_token = TOKEN_INVALID

    def _do_decode(self, tokens: list[int], generated: bool) -> None:
        inst = self._instance
        if len(tokens) > self._max_tokens:
            tokens = tokens[: self._max_tokens]

        ga_factor = self._params.ga_factor
        ctx_len = inst.ctx_len

        if ga_factor == 1:
            # infinite text generation via context shifting (Session.cpp:324-347)
            num = self._num_past + len(tokens)
            if num >= ctx_len:
                if not self._params.infinite_context:
                    raise RuntimeError(f"context limit of {ctx_len} reached")
                num_left = self._num_past - self._num_keep
                num_discard = num_left // 2
                inst.kv_seq_rm(self._num_keep, self._num_keep + num_discard)
                inst.kv_seq_add(self._num_keep + num_discard, self._num_past, -num_discard)
                self._num_past -= num_discard
        else:
            ga_width = self._params.ga_width
            while self._num_past >= self._ga_index + ga_width:
                # Self-Extend grouped attention (Session.cpp:348-368)
                ib = (ga_factor * self._ga_index) // ga_width
                bd = (ga_width // ga_factor) * (ga_factor - 1)
                dd = (ga_width // ga_factor) - ib * bd - ga_width
                inst.kv_seq_add(self._ga_index, self._num_past, ib * bd)
                inst.kv_seq_div(self._ga_index + ib * bd, self._ga_index + ib * bd + ga_width, ga_factor)
                inst.kv_seq_add(self._ga_index + ib * bd + ga_width, self._num_past + ib * bd, dd)
                self._num_past -= bd
                self._ga_index += ga_width // ga_factor

        for t in tokens:
            self._sampler.accept(t, accept_grammar=generated)

        # decode in ≤ batch_size chunks (Session.cpp:380-392)
        bs = inst.batch_size
        off = 0
        while off < len(tokens):
            chunk = tokens[off: off + bs]
            off += len(chunk)
            positions = np.arange(self._num_past, self._num_past + len(chunk), dtype=np.int64)
            self._last_logits = inst.decode(chunk, positions)
            self._num_past += len(chunk)
