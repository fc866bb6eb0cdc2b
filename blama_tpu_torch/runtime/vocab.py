"""Vocabulary + tokenizers built from GGUF metadata.

Host-side replacement for the llama.cpp tokenizer surface consumed by the
reference (llama_tokenize / llama_token_to_piece / llama_vocab_* — see
reference llama/Vocab.cpp:37-72 and SURVEY.md §2.4).

Two families, selected by the GGUF key `tokenizer.ggml.model`:
  * "llama"  → SentencePiece-style score-based BPE with byte fallback
  * "gpt2"   → byte-level BPE with merge ranks and a GPT-2 style pre-tokenizer

Special tokens (CONTROL / USER_DEFINED) are partitioned out of the text before
tokenization when parse_special is set, matching llama.cpp's
tokenizer_st_partition behavior.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Any, Iterable

TOKEN_INVALID = -1

# llama.cpp token attribute types (tokenizer.ggml.token_type values)
TT_UNDEFINED = 0
TT_NORMAL = 1
TT_UNKNOWN = 2
TT_CONTROL = 3
TT_USER_DEFINED = 4
TT_UNUSED = 5
TT_BYTE = 6

SPIECE_UNDERLINE = "▁"  # '▁'


def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2 byte↔unicode bijection (public algorithm from the GPT-2 encoder)."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


_BYTE_ENCODER = _bytes_to_unicode()
_BYTE_DECODER = {v: k for k, v in _BYTE_ENCODER.items()}


# ---------------------------------------------------------------------------
# GPT-2 style pre-tokenizer (hand-rolled scanner; python `re` lacks \p classes)
# ---------------------------------------------------------------------------

def _is_letter(c: str) -> bool:
    return c.isalpha()


def _is_digit(c: str) -> bool:
    return c.isnumeric()


def _gpt2_pretokenize(text: str) -> list[str]:
    """Segment like the GPT-2 regex:
    's|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+
    """
    out: list[str] = []
    i, n = 0, len(text)
    contractions = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
    while i < n:
        c = text[i]
        if c == "'":
            matched = False
            for con in contractions:
                if text.startswith(con, i):
                    out.append(con)
                    i += len(con)
                    matched = True
                    break
            if matched:
                continue
        j = i
        lead = ""
        if c == " " and i + 1 < n and (_is_letter(text[i + 1]) or _is_digit(text[i + 1]) or not text[i + 1].isspace()):
            lead = " "
            j = i + 1
            c = text[j]
        if _is_letter(c):
            k = j
            while k < n and _is_letter(text[k]):
                k += 1
            out.append(lead + text[j:k])
            i = k
            continue
        if _is_digit(c):
            k = j
            while k < n and _is_digit(text[k]):
                k += 1
            out.append(lead + text[j:k])
            i = k
            continue
        if not c.isspace():
            k = j
            while k < n and not text[k].isspace() and not _is_letter(text[k]) and not _is_digit(text[k]):
                k += 1
            out.append(lead + text[j:k])
            i = k
            continue
        # whitespace run: \s+(?!\S) → all but trailing one if followed by non-space
        k = i
        while k < n and text[k].isspace():
            k += 1
        if k < n and k - i > 1:
            out.append(text[i:k - 1])
            i = k - 1
        else:
            out.append(text[i:k])
            i = k
    return out


def _llama3_pretokenize(text: str) -> list[str]:
    """llama-3 style pre-tokenizer: like GPT-2 but case-insensitive
    contractions, digit runs capped at 3, and \\r\\n groups with whitespace."""
    out: list[str] = []
    i, n = 0, len(text)
    contractions = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
    while i < n:
        c = text[i]
        if c == "'" and i + 1 < n:
            matched = False
            for con in contractions:
                if text[i:i + len(con)].lower() == con:
                    out.append(text[i:i + len(con)])
                    i += len(con)
                    matched = True
                    break
            if matched:
                continue
        # [^\r\n\p{L}\p{N}]?\p{L}+
        if _is_letter(c) or (
            c not in "\r\n" and not _is_digit(c) and i + 1 < n and _is_letter(text[i + 1])
        ):
            j = i if _is_letter(c) else i + 1
            lead = "" if _is_letter(c) else c
            k = j
            while k < n and _is_letter(text[k]):
                k += 1
            if k > j:
                out.append(lead + text[j:k])
                i = k
                continue
        # \p{N}{1,3}
        if _is_digit(c):
            k = i
            while k < n and _is_digit(text[k]) and k - i < 3:
                k += 1
            out.append(text[i:k])
            i = k
            continue
        # ' ?[^\s\p{L}\p{N}]+[\r\n]*'
        j = i
        lead = ""
        if c == " " and i + 1 < n and not text[i + 1].isspace() and not _is_letter(text[i + 1]) and not _is_digit(text[i + 1]):
            lead = " "
            j = i + 1
        if j < n and not text[j].isspace() and not _is_letter(text[j]) and not _is_digit(text[j]):
            k = j
            while k < n and not text[k].isspace() and not _is_letter(text[k]) and not _is_digit(text[k]):
                k += 1
            while k < n and text[k] in "\r\n":
                k += 1
            out.append(lead + text[j:k])
            i = k
            continue
        # \s*[\r\n]+
        if c.isspace():
            k = i
            while k < n and text[k].isspace():
                k += 1
            # check for newline run at end
            seg = text[i:k]
            if "\n" in seg or "\r" in seg:
                # \s*[\r\n]+ takes everything through the last newline
                last_nl = max(seg.rfind("\n"), seg.rfind("\r"))
                if last_nl >= 0:
                    out.append(seg[: last_nl + 1])
                    i += last_nl + 1
                    continue
            # \s+(?!\S) | \s+
            if k < n and k - i > 1:
                out.append(text[i:k - 1])
                i = k - 1
            else:
                out.append(text[i:k])
                i = k
            continue
        out.append(c)
        i += 1
    return [s for s in out if s]


# ---------------------------------------------------------------------------
# Tokenizer engines
# ---------------------------------------------------------------------------

class SPMTokenizer:
    """SentencePiece-style BPE: greedy highest-score bigram merge with byte
    fallback (llama.cpp llm_tokenizer_spm semantics)."""

    def __init__(self, vocab: "Vocab"):
        self.vocab = vocab

    def tokenize(self, text: str) -> list[int]:
        v = self.vocab
        if not text:
            return []
        symbols = [c.encode("utf-8") for c in text]
        if not symbols:
            return []

        # (neg_score, left_index, size_snapshot) priority queue of candidate merges
        scores = v.scores
        t2i = v.token_to_id

        prev = list(range(-1, len(symbols) - 1))
        nxt = list(range(1, len(symbols) + 1))
        alive = [True] * len(symbols)

        heap: list[tuple[float, int, int]] = []

        def try_add(left: int):
            right = nxt[left]
            if right >= len(symbols):
                return
            merged = symbols[left] + symbols[right]
            tid = t2i.get(merged)
            if tid is not None:
                heapq.heappush(heap, (-scores[tid], left, len(merged)))

        for i in range(len(symbols) - 1):
            try_add(i)

        while heap:
            _, left, size = heapq.heappop(heap)
            if not alive[left]:
                continue
            right = nxt[left]
            if right >= len(symbols) or not alive[right]:
                continue
            if len(symbols[left]) + len(symbols[right]) != size:
                continue  # stale entry
            symbols[left] = symbols[left] + symbols[right]
            alive[right] = False
            nxt[left] = nxt[right]
            if nxt[left] < len(symbols):
                prev[nxt[left]] = left
            if prev[left] >= 0:
                try_add(prev[left])
            try_add(left)

        out: list[int] = []
        i = 0
        while i < len(symbols):
            if alive[i]:
                self._resegment(symbols[i], out)
            i = nxt[i] if nxt[i] > i else i + 1
        return out

    def _resegment(self, piece: bytes, out: list[int]) -> None:
        v = self.vocab
        tid = v.token_to_id.get(piece)
        if tid is not None:
            out.append(tid)
            return
        for b in piece:
            btid = v.byte_to_id.get(b)
            if btid is not None:
                out.append(btid)
            elif v.unk_id is not None:
                out.append(v.unk_id)


class BPETokenizer:
    """Byte-level BPE with merge ranks (llama.cpp llm_tokenizer_bpe)."""

    def __init__(self, vocab: "Vocab"):
        self.vocab = vocab
        self.ranks: dict[tuple[str, str], int] = {}
        for rank, merge in enumerate(vocab.merges):
            a, sep, b = merge.partition(" ")
            if sep:
                self.ranks[(a, b)] = rank
        pre = vocab.pretokenizer
        if pre in ("llama3", "llama-bpe", "llama-v3", "smaug-bpe"):
            self._pre = _llama3_pretokenize
        else:
            self._pre = _gpt2_pretokenize

    def tokenize(self, text: str) -> list[int]:
        v = self.vocab
        out: list[int] = []
        for word in self._pre(text):
            # map bytes through the gpt2 unicode table
            mapped = "".join(_BYTE_ENCODER[b] for b in word.encode("utf-8"))
            parts = [c for c in mapped]
            while len(parts) > 1:
                best_rank = None
                best_i = -1
                for i in range(len(parts) - 1):
                    r = self.ranks.get((parts[i], parts[i + 1]))
                    if r is not None and (best_rank is None or r < best_rank):
                        best_rank = r
                        best_i = i
                if best_i < 0:
                    break
                parts[best_i: best_i + 2] = [parts[best_i] + parts[best_i + 1]]
            for p in parts:
                tid = v.token_to_id.get(p.encode("utf-8"))
                if tid is not None:
                    out.append(tid)
                else:
                    # fall back to per-char byte tokens
                    for ch in p:
                        ctid = v.token_to_id.get(ch.encode("utf-8"))
                        if ctid is not None:
                            out.append(ctid)
                        elif v.unk_id is not None:
                            out.append(v.unk_id)
        return out


# ---------------------------------------------------------------------------
# Vocab facade
# ---------------------------------------------------------------------------

@dataclass
class Vocab:
    """Facade mirroring the reference Vocab API (Vocab.hpp:16-34) plus the
    special-token queries Session uses (bos/eos/eog/fim, Session.cpp:73,143-158)."""

    tokens: list[str] = field(default_factory=list)
    scores: list[float] = field(default_factory=list)
    token_types: list[int] = field(default_factory=list)
    merges: list[str] = field(default_factory=list)
    model: str = "llama"          # tokenizer.ggml.model
    pretokenizer: str = "default"  # tokenizer.ggml.pre
    bos_id: int | None = None
    eos_id: int | None = None
    eot_id: int | None = None
    eom_id: int | None = None
    unk_id: int | None = None
    pad_id: int | None = None
    sep_id: int | None = None
    fim_pre_id: int | None = None
    fim_suf_id: int | None = None
    fim_mid_id: int | None = None
    add_bos: bool = True
    add_eos: bool = False
    add_space_prefix: bool = True
    decoder_start_id: int | None = None

    def __post_init__(self):
        self.token_to_id: dict[bytes, int] = {}
        self.byte_to_id: dict[int, int] = {}
        self._piece_cache: list[bytes | None] = [None] * len(self.tokens)
        for i, t in enumerate(self.tokens):
            self.token_to_id.setdefault(t.encode("utf-8"), i)
            tt = self.token_types[i] if i < len(self.token_types) else TT_NORMAL
            if tt == TT_BYTE and len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
                self.byte_to_id[int(t[3:5], 16)] = i
        if self.model == "llama":
            self._engine = SPMTokenizer(self)
        elif self.model in ("gpt2", "bpe"):
            self._engine = BPETokenizer(self)
            if self.add_space_prefix:  # gpt2 default: no space prefix
                self.add_space_prefix = False
        else:
            raise NotImplementedError(f"tokenizer model {self.model!r}")
        # special tokens usable for text partitioning
        self._special: list[tuple[str, int]] = sorted(
            (
                (t, i)
                for i, t in enumerate(self.tokens)
                if (self.token_types[i] if i < len(self.token_types) else TT_NORMAL)
                in (TT_CONTROL, TT_USER_DEFINED)
                and t
            ),
            key=lambda p: -len(p[0]),
        )
        self._eog_extra = {
            i
            for i, t in enumerate(self.tokens)
            if t in ("<|eot_id|>", "<|im_end|>", "<|end|>", "<end_of_turn>", "<|endoftext|>", "<|eom_id|>", "<EOT>")
            and (self.token_types[i] if i < len(self.token_types) else TT_NORMAL) == TT_CONTROL
        }

    # -- construction -------------------------------------------------------

    @classmethod
    def from_metadata(cls, md: dict[str, Any]) -> "Vocab":
        def gi(key, default=None):
            val = md.get(f"tokenizer.ggml.{key}", default)
            return int(val) if val is not None else None

        model = md.get("tokenizer.ggml.model", "llama")
        v = cls(
            tokens=list(md.get("tokenizer.ggml.tokens", [])),
            scores=[float(s) for s in md.get("tokenizer.ggml.scores", [])] or [0.0] * len(md.get("tokenizer.ggml.tokens", [])),
            token_types=[int(t) for t in md.get("tokenizer.ggml.token_type", [])],
            merges=list(md.get("tokenizer.ggml.merges", [])),
            model=model,
            pretokenizer=md.get("tokenizer.ggml.pre", "default"),
            bos_id=gi("bos_token_id"),
            eos_id=gi("eos_token_id"),
            eot_id=gi("eot_token_id"),
            eom_id=gi("eom_token_id"),
            unk_id=gi("unknown_token_id"),
            pad_id=gi("padding_token_id"),
            sep_id=gi("separator_token_id"),
            fim_pre_id=gi("fim_pre_token_id", gi("prefix_token_id")),
            fim_suf_id=gi("fim_suf_token_id", gi("suffix_token_id")),
            fim_mid_id=gi("fim_mid_token_id", gi("middle_token_id")),
            add_bos=bool(md.get("tokenizer.ggml.add_bos_token", model == "llama")),
            add_eos=bool(md.get("tokenizer.ggml.add_eos_token", False)),
            add_space_prefix=bool(md.get("tokenizer.ggml.add_space_prefix", model == "llama")),
        )
        for key, val in md.items():
            if key.endswith(".decoder_start_token_id") and val is not None:
                v.decoder_start_id = int(val)
        return v

    @classmethod
    def from_gguf(cls, reader) -> "Vocab":
        return cls.from_metadata(reader.metadata)

    # -- queries (reference Vocab API) --------------------------------------

    @property
    def n_tokens(self) -> int:
        return len(self.tokens)

    def bos(self) -> int:
        return self.bos_id if self.bos_id is not None else TOKEN_INVALID

    def eos(self) -> int:
        return self.eos_id if self.eos_id is not None else TOKEN_INVALID

    def fim_pre(self) -> int:
        return self.fim_pre_id if self.fim_pre_id is not None else TOKEN_INVALID

    def fim_suf(self) -> int:
        return self.fim_suf_id if self.fim_suf_id is not None else TOKEN_INVALID

    def fim_mid(self) -> int:
        return self.fim_mid_id if self.fim_mid_id is not None else TOKEN_INVALID

    def decoder_start_token(self) -> int:
        """Reference: Vocab::decoderStartToken falls back to BOS (Vocab.cpp:22-27)."""
        if self.decoder_start_id is not None:
            return self.decoder_start_id
        return self.bos()

    def is_eog(self, token: int) -> bool:
        if token < 0:
            return False
        return token in (self.eos_id, self.eot_id, self.eom_id) or token in self._eog_extra

    def should_add_bos(self) -> bool:
        return self.add_bos

    # -- tokenize / detokenize ---------------------------------------------

    def tokenize(self, text: str, add_special: bool, parse_special: bool) -> list[int]:
        """llama_tokenize-equivalent (reference call site Vocab.cpp:37-51)."""
        fragments: list[tuple[bool, Any]] = []  # (is_token, str|id)
        if parse_special and self._special:
            fragments = self._partition_special(text)
        else:
            fragments = [(False, text)] if text else []

        out: list[int] = []
        if add_special and self.add_bos and self.bos_id is not None:
            out.append(self.bos_id)

        is_prev_special = True  # allows space-prefix on the first raw fragment
        for is_tok, frag in fragments:
            if is_tok:
                out.append(frag)
                is_prev_special = True
                continue
            raw = frag
            if not raw:
                continue
            if self.model == "llama":
                if self.add_space_prefix and is_prev_special and len(out) <= (1 if (add_special and self.add_bos) else 0):
                    raw = " " + raw
                raw = raw.replace(" ", SPIECE_UNDERLINE)
            out.extend(self._engine.tokenize(raw))
            is_prev_special = False

        if add_special and self.add_eos and self.eos_id is not None:
            out.append(self.eos_id)
        return out

    def _partition_special(self, text: str) -> list[tuple[bool, Any]]:
        frags: list[tuple[bool, Any]] = [(False, text)]
        for special_text, special_id in self._special:
            new_frags: list[tuple[bool, Any]] = []
            for is_tok, frag in frags:
                if is_tok:
                    new_frags.append((is_tok, frag))
                    continue
                rest = frag
                while True:
                    idx = rest.find(special_text)
                    if idx < 0:
                        if rest:
                            new_frags.append((False, rest))
                        break
                    if idx > 0:
                        new_frags.append((False, rest[:idx]))
                    new_frags.append((True, special_id))
                    rest = rest[idx + len(special_text):]
            frags = new_frags
        return frags

    def token_piece(self, token: int, special: bool = True) -> bytes:
        """Byte-level rendering of one token (llama_token_to_piece)."""
        if token < 0 or token >= len(self.tokens):
            return b""
        tt = self.token_types[token] if token < len(self.token_types) else TT_NORMAL
        text = self.tokens[token]
        if tt == TT_BYTE:
            if self.model == "llama" and text.startswith("<0x"):
                return bytes([int(text[3:5], 16)])
            return text.encode("utf-8")
        if tt == TT_CONTROL:
            return text.encode("utf-8") if special else b""
        if tt in (TT_UNKNOWN, TT_UNUSED):
            return text.encode("utf-8") if special else b""
        if self.model == "llama":
            return text.replace(SPIECE_UNDERLINE, " ").encode("utf-8")
        # gpt2: decode through the byte table
        return bytes(_BYTE_DECODER.get(c, ord("?") & 0xFF) for c in text)

    def token_to_string(self, token: int, special: bool = True) -> str:
        """Reference: Vocab::tokenToString (Vocab.cpp:53-72)."""
        return self.token_piece(token, special).decode("utf-8", errors="replace")

    def detokenize(self, tokens: Iterable[int], special: bool = False) -> str:
        data = b"".join(self.token_piece(t, special) for t in tokens)
        return data.decode("utf-8", errors="replace")
