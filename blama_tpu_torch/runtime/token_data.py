"""Token/logit record types (reference: Token.hpp — TokenData, TokenDataVector,
TokenPrediction with top-10 logit capture, Session.hpp:20-27)."""

from __future__ import annotations

from dataclasses import dataclass, field

TOKEN_INVALID = -1


@dataclass(frozen=True)
class TokenData:
    token: int
    logit: float


TokenDataVector = list  # list[TokenData]


@dataclass
class TokenPrediction:
    token: int
    logits: TokenDataVector = field(default_factory=list)
