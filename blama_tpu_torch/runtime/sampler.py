"""Sampler chain: the llama.cpp primitive set with blama's orchestration.

Re-implements the sampler surface the reference configures
(reference llama/Sampler.{hpp,cpp}): logit-bias →
penalties → (mirostat v1/v2 | configurable sequence of top-k / typical-p /
top-p / min-p / temp-ext / XTC → dist(seed)), plus the grammar
sample-then-check-then-resample strategy (Sampler.cpp:126-173).

Host-side numpy implementation operating on full-vocab logits; deterministic
given a seed (counter-based Philox RNG — we define our own RNG stream rather
than matching std::mt19937 bit-for-bit; determinism contracts are pinned by
our own tests, mirroring t-integration.cpp:92-120).
"""

from __future__ import annotations

import enum
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from .vocab import Vocab

TOKEN_INVALID = -1


class SamplingType(enum.Enum):
    TOP_K = "top_k"
    TOP_P = "top_p"
    MIN_P = "min_p"
    TYPICAL_P = "typical_p"
    TEMPERATURE = "temperature"
    XTC = "xtc"
    INFILL = "infill"


@dataclass
class RepetitionPenalty:
    num_tokens: int = 64      # last n tokens to penalize (0 = off, -1 = ctx size)
    repeat: float = 1.0
    freq: float = 0.0
    present: float = 0.0


@dataclass
class Mirostat:
    ver: int = 0              # 0 off, 1 v1, 2 v2
    tau: float = 5.0
    eta: float = 0.1


@dataclass
class XTC:
    probability: float = 0.0
    threshold: float = 0.1


@dataclass
class SamplerParams:
    """Mirror of Sampler::Params (Sampler.hpp:34-77)."""

    rng_seed: int = 0
    min_keep: int = 0
    top_k: int = 40
    top_p: float = 0.95
    min_p: float = 0.05
    tfs_z: float = 1.0
    typical_p: float = 1.0
    temp: float = 0.80
    temp_range: float = 0.0
    temp_exp: float = 1.0
    repetition_penalty: RepetitionPenalty = field(default_factory=RepetitionPenalty)
    mirostat: Mirostat = field(default_factory=Mirostat)
    xtc: XTC = field(default_factory=XTC)
    sampler_sequence: list[SamplingType] = field(
        default_factory=lambda: [
            SamplingType.TOP_K,
            SamplingType.TYPICAL_P,
            SamplingType.TOP_P,
            SamplingType.MIN_P,
            SamplingType.TEMPERATURE,
        ]
    )
    grammar: str = ""
    logit_bias: dict[int, float] = field(default_factory=dict)


class _Candidates:
    """(ids, logits) working set, analog of llama_token_data_array."""

    __slots__ = ("ids", "logits", "sorted")

    def __init__(self, logits: np.ndarray):
        self.ids = np.arange(logits.shape[0], dtype=np.int64)
        self.logits = logits.astype(np.float32).copy()
        self.sorted = False

    def sort_desc(self) -> None:
        if not self.sorted:
            order = np.argsort(-self.logits, kind="stable")
            self.ids = self.ids[order]
            self.logits = self.logits[order]
            self.sorted = True

    def probs(self) -> np.ndarray:
        m = self.logits.max()
        e = np.exp(self.logits - m)
        return e / e.sum()

    def keep(self, mask_or_count) -> None:
        if isinstance(mask_or_count, (int, np.integer)):
            self.ids = self.ids[:mask_or_count]
            self.logits = self.logits[:mask_or_count]
        else:
            self.ids = self.ids[mask_or_count]
            self.logits = self.logits[mask_or_count]


class Sampler:
    """Stateful chain (penalty history, mirostat mu, RNG), mirror of the
    reference Sampler lifecycle: accept() feeds state, reset() clears it
    (Sampler.cpp:101-107, 175-178)."""

    def __init__(self, vocab: Vocab, params: SamplerParams | None = None, grammar_sampler=None):
        self.vocab = vocab
        self.params = params or SamplerParams()
        self._grammar = grammar_sampler
        if self._grammar is None and self.params.grammar:
            from .grammar import GrammarSampler  # lazy; optional subsystem

            self._grammar = GrammarSampler(self.params.grammar, vocab)
        self.reset(reseed=True)

    # -- lifecycle ----------------------------------------------------------

    def reset(self, reseed: bool = True) -> None:
        p = self.params
        n = p.repetition_penalty.num_tokens
        self._history: deque[int] = deque(maxlen=max(n, 0) or None)
        self._mu: float | None = None
        if reseed:
            self._rng = np.random.Generator(np.random.Philox(np.uint64(p.rng_seed)))
            self._xtc_rng = np.random.Generator(np.random.Philox(np.uint64(p.rng_seed) + np.uint64(0x9E3779B9)))
        if self._grammar is not None:
            self._grammar.reset()

    def accept(self, token: int, accept_grammar: bool) -> None:
        if token < 0:
            return
        if accept_grammar and self._grammar is not None:
            self._grammar.accept(token)
        if self.params.repetition_penalty.num_tokens != 0:
            self._history.append(int(token))

    # -- chain application --------------------------------------------------

    def sample(self, logits: np.ndarray, grammar_first: bool = False) -> int:
        """Full-vocab logits -> token id, with the reference's grammar
        check/resample strategy (Sampler.cpp:126-173)."""
        cand = _Candidates(logits)
        if grammar_first and self._grammar is not None:
            self._grammar.apply(cand)
        tok = self._apply_chain_and_pick(cand)

        if grammar_first or self._grammar is None:
            return tok
        if self._grammar.token_allowed(tok):
            return tok
        # resample: grammar constraints first, then the chain
        cand = _Candidates(logits)
        self._grammar.apply(cand)
        return self._apply_chain_and_pick(cand)

    def _apply_chain_and_pick(self, cand: _Candidates) -> int:
        p = self.params
        self._apply_logit_bias(cand)
        self._apply_penalties(cand)
        if p.mirostat.ver == 1:
            self._apply_temp(cand, p.temp)
            return self._mirostat_v1(cand)
        if p.mirostat.ver == 2:
            self._apply_temp(cand, p.temp)
            return self._mirostat_v2(cand)
        if p.mirostat.ver > 2:
            raise ValueError("Unsupported mirostat version")
        for st in p.sampler_sequence:
            if st == SamplingType.TOP_K:
                self._apply_top_k(cand, p.top_k)
            elif st == SamplingType.TYPICAL_P:
                self._apply_typical(cand, p.typical_p, p.min_keep)
            elif st == SamplingType.TOP_P:
                self._apply_top_p(cand, p.top_p, p.min_keep)
            elif st == SamplingType.MIN_P:
                self._apply_min_p(cand, p.min_p, p.min_keep)
            elif st == SamplingType.TEMPERATURE:
                self._apply_temp_ext(cand, p.temp, p.temp_range, p.temp_exp)
            elif st == SamplingType.XTC:
                self._apply_xtc(cand, p.xtc.probability, p.xtc.threshold, p.min_keep)
            elif st == SamplingType.INFILL:
                self._apply_infill(cand)
            else:
                raise ValueError(f"Unsupported sampler type {st}")
        return self._dist_pick(cand)

    # -- primitives ---------------------------------------------------------

    def _apply_logit_bias(self, cand: _Candidates) -> None:
        # runs first in the chain, while ids are still the identity mapping
        for tok, bias in self.params.logit_bias.items():
            if not cand.sorted and 0 <= tok < cand.logits.shape[0]:
                cand.logits[tok] += bias
            else:
                cand.logits[cand.ids == tok] += bias

    def _apply_penalties(self, cand: _Candidates) -> None:
        rp = self.params.repetition_penalty
        if rp.num_tokens == 0 or not self._history:
            return
        if rp.repeat == 1.0 and rp.freq == 0.0 and rp.present == 0.0:
            return
        counts: dict[int, int] = {}
        for t in self._history:
            counts[t] = counts.get(t, 0) + 1
        idx_of = {int(t): i for i, t in enumerate(cand.ids)} if cand.sorted else None
        for tok, cnt in counts.items():
            i = idx_of.get(tok) if idx_of is not None else (tok if tok < cand.logits.shape[0] else None)
            if i is None:
                continue
            lg = cand.logits[i]
            if rp.repeat != 1.0:
                lg = lg * rp.repeat if lg <= 0 else lg / rp.repeat
            lg -= cnt * rp.freq + (1.0 if cnt > 0 else 0.0) * rp.present
            cand.logits[i] = lg

    def _apply_top_k(self, cand: _Candidates, k: int) -> None:
        if k <= 0 or k >= cand.ids.shape[0]:
            return
        cand.sort_desc()
        cand.keep(k)

    def _apply_top_p(self, cand: _Candidates, top_p: float, min_keep: int) -> None:
        if top_p >= 1.0:
            return
        cand.sort_desc()
        probs = cand.probs()
        cum = np.cumsum(probs)
        # keep up to and including first index where cum >= p
        cut = int(np.searchsorted(cum, top_p) + 1)
        cut = max(cut, max(min_keep, 1))
        cand.keep(cut)

    def _apply_min_p(self, cand: _Candidates, min_p: float, min_keep: int) -> None:
        if min_p <= 0.0 or cand.ids.shape[0] == 0:
            return
        cand.sort_desc()
        max_l = cand.logits[0]
        thresh = max_l + np.log(min_p)
        mask = cand.logits >= thresh
        n = max(int(mask.sum()), max(min_keep, 1))
        cand.keep(max(n, 1))

    def _apply_typical(self, cand: _Candidates, typical_p: float, min_keep: int) -> None:
        if typical_p >= 1.0:
            return
        probs = _Candidates.probs(cand)
        entropy = -np.sum(probs * np.log(np.maximum(probs, 1e-30)))
        shifted = np.abs(-np.log(np.maximum(probs, 1e-30)) - entropy)
        order = np.argsort(shifted, kind="stable")
        sorted_probs = probs[order]
        cum = np.cumsum(sorted_probs)
        cut = int(np.searchsorted(cum, typical_p) + 1)
        cut = max(cut, max(min_keep, 1))
        sel = order[:cut]
        cand.ids = cand.ids[sel]
        cand.logits = cand.logits[sel]
        cand.sorted = False

    def _apply_temp(self, cand: _Candidates, temp: float) -> None:
        if temp <= 0.0:
            # greedy: collapse to argmax (llama.cpp temp<=0 behavior)
            i = int(np.argmax(cand.logits))
            cand.ids = cand.ids[i: i + 1]
            cand.logits = cand.logits[i: i + 1]
            cand.sorted = True
            return
        cand.logits /= temp

    def _apply_temp_ext(self, cand: _Candidates, temp: float, delta: float, exponent: float) -> None:
        if delta <= 0.0:
            self._apply_temp(cand, temp)
            return
        if cand.ids.shape[0] <= 1:
            return
        min_t = max(0.0, temp - delta)
        max_t = temp + delta
        probs = cand.probs()
        entropy = -np.sum(probs * np.log(np.maximum(probs, 1e-30)))
        max_entropy = np.log(cand.ids.shape[0])
        norm = entropy / max_entropy if max_entropy > 0 else 0.0
        dyn = min_t + (max_t - min_t) * (norm**exponent)
        self._apply_temp(cand, float(dyn))

    def _apply_xtc(self, cand: _Candidates, probability: float, threshold: float, min_keep: int) -> None:
        if probability <= 0.0 or threshold > 0.5 or cand.ids.shape[0] < 2:
            return
        if self._xtc_rng.random() > probability:
            return
        cand.sort_desc()
        probs = cand.probs()
        above = probs >= threshold
        n_above = int(above.sum())
        if n_above < 2:
            return
        # remove all but the LAST token above the threshold
        keep_mask = np.ones(cand.ids.shape[0], bool)
        keep_mask[: n_above - 1] = False
        if keep_mask.sum() < max(min_keep, 1):
            return
        cand.keep(keep_mask)

    def _apply_infill(self, cand: _Candidates) -> None:
        # llama.cpp's infill sampler merges EOG probability mass; a simplified
        # variant: if EOG mass dominates by 4x, force EOG.
        probs = cand.probs()
        eog_mask = np.fromiter((self.vocab.is_eog(int(t)) for t in cand.ids), bool, cand.ids.shape[0])
        p_eog = probs[eog_mask].sum()
        p_txt = probs[~eog_mask].sum()
        if eog_mask.any() and p_eog > 4 * max(p_txt, 1e-30):
            sel = np.flatnonzero(eog_mask)[:1]
            cand.ids = cand.ids[sel]
            cand.logits = cand.logits[sel]
            cand.sorted = True

    def _dist_pick(self, cand: _Candidates) -> int:
        probs = cand.probs()
        if probs.shape[0] == 1:
            return int(cand.ids[0])
        r = self._rng.random()
        cum = np.cumsum(probs)
        i = int(np.searchsorted(cum, r * cum[-1]))
        i = min(i, probs.shape[0] - 1)
        return int(cand.ids[i])

    # -- mirostat -----------------------------------------------------------

    def _mirostat_v1(self, cand: _Candidates, m: int = 100) -> int:
        p = self.params
        n_vocab = self.vocab.n_tokens
        if self._mu is None:
            self._mu = 2.0 * p.mirostat.tau
        cand.sort_desc()
        probs = cand.probs()
        top = probs[: max(2, min(m, probs.shape[0]))]
        # estimate s_hat from the top-m zipf fit (llama.cpp formula)
        num, den = 0.0, 0.0
        for i in range(top.shape[0] - 1):
            t = np.log((i + 2) / (i + 1))
            b = np.log(top[i] / np.maximum(top[i + 1], 1e-30))
            num += t * b
            den += t * t
        s_hat = num / max(den, 1e-30)
        eps = s_hat - 1
        k = ((eps * (2**self._mu)) / (1 - n_vocab ** (-eps))) ** (1 / s_hat)
        self._apply_top_k(cand, max(1, int(k)))
        tok = self._dist_pick(cand)
        idx = int(np.flatnonzero(cand.ids == tok)[0])
        surprise = -np.log2(np.maximum(cand.probs()[idx], 1e-30))
        self._mu -= p.mirostat.eta * (surprise - p.mirostat.tau)
        return tok

    def _mirostat_v2(self, cand: _Candidates) -> int:
        p = self.params
        if self._mu is None:
            self._mu = 2.0 * p.mirostat.tau
        cand.sort_desc()
        probs = cand.probs()
        surprise = -np.log2(np.maximum(probs, 1e-30))
        mask = surprise <= self._mu
        if not mask.any():
            mask[0] = True
        cand.keep(mask)
        tok = self._dist_pick(cand)
        idx = int(np.flatnonzero(cand.ids == tok)[0])
        observed = -np.log2(np.maximum(cand.probs()[idx], 1e-30))
        self._mu -= p.mirostat.eta * (observed - p.mirostat.tau)
        return tok
