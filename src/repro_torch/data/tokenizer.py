"""Hash word tokenizer (offline-friendly stand-in for the UniLM wordpiece
vocab): lowercase word -> stable hash bucket in [2, vocab). 0 = PAD, 1 = CLS.
Deterministic across processes (no PYTHONHASHSEED dependence)."""
from __future__ import annotations

import hashlib
import re

PAD, CLS = 0, 1
_WORD_RE = re.compile(r"[a-z0-9']+")


def words(text: str):
    return _WORD_RE.findall(text.lower())


def hash_token(word: str, vocab: int) -> int:
    h = int.from_bytes(hashlib.md5(word.encode()).digest()[:8], "little")
    return 2 + h % (vocab - 2)


def encode(text: str, vocab: int, max_len: int, *, add_cls: bool = True):
    toks = [CLS] if add_cls else []
    toks += [hash_token(w, vocab) for w in words(text)]
    toks = toks[:max_len]
    return toks + [PAD] * (max_len - len(toks))
