"""HF ``tokenizer.json`` loader: byte-level BPE, pure Python (port of
``kubetpu/jobs/tokenizer.py``).

A ``hf_import.params_from_hf`` checkpoint plus this loader serves prompt
strings end to end with no Rust ``tokenizers`` dependency at run time.

Covers the llama-3 family layout and the GPT-2 byte-level layout:

- model ``type: "BPE"`` — vocab (token string -> id) + ranked merges;
  ``ignore_merges: true`` (llama-3 / tiktoken convention: a pretoken that
  is itself a vocab entry short-circuits the merge loop).
- byte-level alphabet: text is UTF-8 bytes mapped through the standard
  GPT-2 printable-unicode table, so every input is encodable and decode
  is exact byte reconstruction.
- pretokenizer: ``Split`` with a regex pattern (llama-3's tiktoken-style
  pattern), ``ByteLevel`` (with the GPT-2 pattern when ``use_regex``), or
  a ``Sequence`` of those.
- added/special tokens: matched greedily before pretokenization, emitted
  as single ids, skippable on decode.

The patterns use ``\\p{L}`` / ``\\p{N}`` classes, which the stdlib ``re``
rejects, and the port needs no ``regex`` module: ``translate_pattern``
rewrites each Unicode property class (bare, negated, or inside a bracket
expression) and each ``\\s`` / ``\\S`` into explicit code-point ranges
built once from ``unicodedata``, and the result compiles under ``re``.
``\\s`` is Unicode ``White_Space`` (what the ``regex`` module and the Rust
tokenizer match), not ``str.isspace``, which also takes U+001C..U+001F.
On code points that Python's ``unicodedata`` assigns, the translated
pattern matches what the ``regex`` module matches; on code points that
only a newer Unicode version assigns, the two may differ.

The encoder is exact BPE (lowest-rank merge first), memoized per
pretoken.
"""

from __future__ import annotations

import json
import os
import re
import sys
import unicodedata
from functools import lru_cache
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# GPT-2 byte-level pretokenizer pattern (ByteLevel use_regex=true)
GPT2_PATTERN = (
    r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"
)

# Unicode White_Space: what ``\s`` means to the regex module and to the
# Rust tokenizer (stdlib ``re``'s ``\s`` adds U+001C..U+001F)
_WHITE_SPACE = ((0x09, 0x0D), (0x20, 0x20), (0x85, 0x85), (0xA0, 0xA0),
                (0x1680, 0x1680), (0x2000, 0x200A), (0x2028, 0x2029),
                (0x202F, 0x202F), (0x205F, 0x205F), (0x3000, 0x3000))


@lru_cache(maxsize=1)
def _category_runs() -> Tuple[Tuple[int, int, str], ...]:
    """Every code point's general category, as (first, last, category)
    runs: one pass over ``unicodedata``."""
    runs: List[List] = []
    for cp in range(sys.maxunicode + 1):
        cat = unicodedata.category(chr(cp))
        if runs and runs[-1][2] == cat:
            runs[-1][1] = cp
        else:
            runs.append([cp, cp, cat])
    return tuple((a, b, c) for a, b, c in runs)


@lru_cache(maxsize=None)
def _category_ranges(prefix: str) -> Tuple[Tuple[int, int], ...]:
    """The code points whose general category starts with *prefix* ("L",
    "N", "Lu", ...), as sorted inclusive ranges."""
    ranges: List[List[int]] = []
    for a, b, cat in _category_runs():
        if cat.startswith(prefix):
            if ranges and ranges[-1][1] == a - 1:
                ranges[-1][1] = b
            else:
                ranges.append([a, b])
    if not ranges:
        raise ValueError(f"unknown Unicode property \\p{{{prefix}}}")
    return tuple((a, b) for a, b in ranges)


def _ranges_text(ranges) -> str:
    """Inclusive ranges as the inside of a bracket expression."""
    return "".join(f"\\U{a:08x}" if a == b else f"\\U{a:08x}-\\U{b:08x}"
                   for a, b in ranges)


def _property(name: str) -> str:
    """The ranges of general category *name* ("L", "N", "Lu", ...)."""
    if not (1 <= len(name) <= 2 and name[0] in "LMNPSZC"):
        raise ValueError(f"unsupported Unicode property \\p{{{name}}}")
    return _ranges_text(_category_ranges(name))


@lru_cache(maxsize=256)
def translate_pattern(pattern: str) -> str:
    """Rewrite a ``regex``-module pattern into one the stdlib ``re``
    compiles with the same matches: ``\\p{X}`` -> ``[ranges]``, ``\\P{X}``
    -> ``[^ranges]``, ``\\s`` -> ``[White_Space]``, ``\\S`` ->
    ``[^White_Space]``; inside a bracket expression ``\\p{X}`` and ``\\s``
    contribute their ranges. A construct with no bracket form (``\\P{X}``
    or ``\\S`` inside brackets) raises ``ValueError``."""
    ws = _ranges_text(_WHITE_SPACE)
    out: List[str] = []
    i, n = 0, len(pattern)
    in_class = False
    class_start = 0          # index in `out` where the current class began
    while i < n:
        c = pattern[i]
        if c == "\\" and i + 1 < n:
            e = pattern[i + 1]
            if e in "pP" and i + 2 < n and pattern[i + 2] == "{":
                close = pattern.index("}", i + 3)
                body = _property(pattern[i + 3:close])
                i = close + 1
                if in_class:
                    if e == "P":
                        raise ValueError("\\P{...} inside a bracket "
                                         "expression is not supported")
                    out.append(body)
                else:
                    out.append(("[" if e == "p" else "[^") + body + "]")
                continue
            if e in "sS":
                if in_class:
                    if e == "S":
                        raise ValueError("\\S inside a bracket expression "
                                         "is not supported")
                    out.append(ws)
                else:
                    out.append(("[" if e == "s" else "[^") + ws + "]")
                i += 2
                continue
            out.append(pattern[i:i + 2])
            i += 2
            continue
        if not in_class and c == "[":
            in_class = True
            out.append(c)
            i += 1
            class_start = len(out)
            if i < n and pattern[i] == "^":
                out.append("^")
                i += 1
                class_start = len(out)
            if i < n and pattern[i] == "]":     # a literal ] first
                out.append("\\]")
                i += 1
            continue
        if in_class and c == "]" and len(out) > class_start:
            in_class = False
        out.append(c)
        i += 1
    return "".join(out)


def _compile(pattern: str):
    return re.compile(translate_pattern(pattern))


@lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """The GPT-2 byte <-> printable-unicode bijection: the 188 'nice'
    bytes map to themselves, the rest to 256+offset — so every byte
    sequence is a string of printable vocab characters."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _parse_pretokenizer(node) -> List[Tuple[str, str]]:
    """tokenizer.json pre_tokenizer -> ordered (regex, behavior) splits.
    Behaviors: ``Isolated`` (matches AND the spans between them become
    pieces) and ``Removed`` (matches are dropped, the spans between them
    become pieces). Unknown pretokenizer types or behaviors refuse
    loudly: silently skipping one would produce a tokenizer that encodes
    differently from the checkpoint's."""
    if node is None:
        return []
    t = node.get("type")
    if t == "Sequence":
        out: List[Tuple[str, str]] = []
        for sub in node["pretokenizers"]:
            out.extend(_parse_pretokenizer(sub))
        return out
    if t == "Split":
        if node.get("invert"):
            raise ValueError("Split with invert=true is not supported")
        behavior = node.get("behavior", "Isolated")
        if behavior not in ("Isolated", "Removed"):
            raise ValueError(
                f"Split behavior {behavior!r} is not supported "
                f"(Isolated, Removed)"
            )
        pat = node["pattern"]
        if "Regex" in pat:
            return [(pat["Regex"], behavior)]
        return [(re.escape(pat["String"]), behavior)]
    if t == "ByteLevel":
        # the byte mapping itself is applied unconditionally downstream;
        # here only its optional GPT-2 regex contributes a split
        return [(GPT2_PATTERN, "Isolated")] if node.get("use_regex", True) else []
    raise ValueError(
        f"unsupported pre_tokenizer type {t!r}: loading would silently "
        f"mis-tokenize (supported: Sequence, Split, ByteLevel)"
    )


def _split_piece(piece: str, pat, behavior: str) -> Iterable[str]:
    """Apply one split to one piece, PRESERVING non-matching spans (the
    gap between matches is a piece too — dropping it would silently eat
    input text)."""
    pos = 0
    for m in pat.finditer(piece):
        if m.start() > pos:
            yield piece[pos : m.start()]
        if behavior == "Isolated" and m.group(0):
            yield m.group(0)
        pos = m.end()
    if pos < len(piece):
        yield piece[pos:]


class BpeTokenizer:
    """Byte-level BPE tokenizer loaded from an HF ``tokenizer.json``.

    ``encode(text)`` -> ids (optionally with BOS/EOS), ``decode(ids)`` ->
    text. Special tokens round-trip as literal text unless skipped.
    """

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: Sequence[Tuple[str, str]],
        special_tokens: Optional[Dict[str, int]] = None,
        added_tokens: Optional[Dict[str, int]] = None,
        split_patterns: Optional[Sequence] = None,
        ignore_merges: bool = False,
        bos_token: Optional[str] = None,
        eos_token: Optional[str] = None,
    ) -> None:
        """``added_tokens`` covers EVERY added token (matched before
        pretokenization, like the Rust added-tokens trie);
        ``special_tokens`` is the subset ``decode(skip_special=True)``
        strips. ``split_patterns=None`` means "use the GPT-2 byte-level
        pattern" (constructor convenience); an EMPTY list means a real
        no-pretokenizer config — BPE over whole chunks."""
        self.vocab = dict(vocab)
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self.ranks = {tuple(m): r for r, m in enumerate(merges)}
        self.special_tokens = dict(special_tokens or {})
        self.added_tokens = dict(added_tokens or {})
        for t, i in self.special_tokens.items():
            self.added_tokens.setdefault(t, i)
        self.id_to_added = {i: t for t, i in self.added_tokens.items()}
        self._special_ids = set(self.special_tokens.values())
        self.ignore_merges = ignore_merges
        if split_patterns is None:
            split_patterns = [(GPT2_PATTERN, "Isolated")]
        self._splits = [
            (_compile(p), b)
            for p, b in (
                (s, "Isolated") if isinstance(s, str) else s
                for s in split_patterns
            )
        ]
        if self.added_tokens:
            # longest-first so overlapping tokens (<|eot|> vs <|eot_id|>)
            # match maximally, like the Rust added-tokens trie
            alt = "|".join(
                re.escape(t)
                for t in sorted(self.added_tokens, key=len, reverse=True)
            )
            self._added_re = re.compile(f"({alt})")
        else:
            self._added_re = None
        self._byte_enc = bytes_to_unicode()
        self._byte_dec = {c: b for b, c in self._byte_enc.items()}
        self._cache: Dict[str, List[int]] = {}
        self.bos_token = bos_token
        self.eos_token = eos_token
        self.bos_id = self.special_tokens.get(bos_token) if bos_token else None
        self.eos_id = self.special_tokens.get(eos_token) if eos_token else None

    # -- loading -------------------------------------------------------------

    @classmethod
    def from_file(cls, path: str) -> "BpeTokenizer":
        with open(path, encoding="utf-8") as f:
            obj = json.load(f)
        return cls.from_json(obj)

    @classmethod
    def from_json(cls, obj: dict) -> "BpeTokenizer":
        model = obj.get("model", {})
        if model.get("type") != "BPE":
            raise ValueError(
                f"unsupported model type {model.get('type')!r} (only BPE)"
            )
        if model.get("byte_fallback"):
            raise ValueError(
                "byte_fallback BPE (sentencepiece-style, llama-2) is not "
                "supported; use a byte-level checkpoint (llama-3, gpt2)"
            )
        # This loader implements BYTE-LEVEL BPE: text is byte-mapped through
        # the GPT-2 table before BPE (and inverted on decode). A layout with
        # no ByteLevel component anywhere does its BPE over raw characters —
        # loading it here would silently byte-map anyway and diverge.
        def _has_bytelevel(node) -> bool:
            if not isinstance(node, dict):
                return False
            if node.get("type") == "ByteLevel":
                return True
            return any(
                _has_bytelevel(sub) for sub in node.get("pretokenizers", [])
            )

        if not (_has_bytelevel(obj.get("pre_tokenizer"))
                or _has_bytelevel(obj.get("decoder"))):
            raise ValueError(
                "tokenizer.json has no ByteLevel pretokenizer/decoder: only "
                "byte-level BPE layouts (llama-3, gpt2) are supported"
            )
        vocab = dict(model["vocab"])
        merges = [
            tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
            for m in model.get("merges", [])
        ]
        added = {
            t["content"]: int(t["id"]) for t in obj.get("added_tokens", [])
        }
        specials = {
            t["content"]: int(t["id"])
            for t in obj.get("added_tokens", [])
            if t.get("special", True)
        }
        vocab.update(added)  # added tokens are addressable ids too
        bos = eos = None
        # best-effort identity from conventional names; the TemplateProcessing
        # post-processor is not interpreted (chat templates live above this
        # layer), only single BOS/EOS framing
        for name in ("<|begin_of_text|>", "<s>", "<bos>"):
            if name in specials:
                bos = name
                break
        for name in ("<|end_of_text|>", "</s>", "<eos>", "<|endoftext|>"):
            if name in specials:
                eos = name
                break
        return cls(
            vocab,
            merges,
            special_tokens=specials,
            added_tokens=added,
            split_patterns=_parse_pretokenizer(obj.get("pre_tokenizer")),
            ignore_merges=bool(model.get("ignore_merges", False)),
            bos_token=bos,
            eos_token=eos,
        )

    # -- encoding ------------------------------------------------------------

    @property
    def vocab_size(self) -> int:
        return max(max(self.vocab.values()), *([-1] + list(self.id_to_added))) + 1

    def _bpe(self, piece: str) -> List[int]:
        """Exact BPE over one byte-mapped pretoken: repeatedly merge the
        lowest-rank adjacent pair (the training order), then map symbols
        to ids."""
        hit = self._cache.get(piece)
        if hit is not None:
            return hit
        if self.ignore_merges and piece in self.vocab:
            out = [self.vocab[piece]]
            self._cache[piece] = out
            return out
        word = list(piece)
        while len(word) > 1:
            best_rank = None
            best_i = -1
            for i in range(len(word) - 1):
                r = self.ranks.get((word[i], word[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            word[best_i : best_i + 2] = [word[best_i] + word[best_i + 1]]
        try:
            out = [self.vocab[w] for w in word]
        except KeyError as e:  # un-merged symbol outside the vocab
            raise ValueError(
                f"symbol {e.args[0]!r} is not in the vocabulary — the "
                f"checkpoint's alphabet does not cover this input"
            ) from None
        if len(self._cache) > 65536:  # bound the memo on adversarial input
            self._cache.clear()
        self._cache[piece] = out
        return out

    def _encode_chunk(self, text: str) -> List[int]:
        """Pretokenize (split patterns in sequence, gap-preserving) +
        byte-map + BPE."""
        pieces = [text]
        for pat, behavior in self._splits:
            nxt: List[str] = []
            for p in pieces:
                nxt.extend(_split_piece(p, pat, behavior))
            pieces = nxt
        out: List[int] = []
        for p in pieces:
            mapped = "".join(self._byte_enc[b] for b in p.encode("utf-8"))
            out.extend(self._bpe(mapped))
        return out

    def encode(
        self, text: str, bos: bool = False, eos: bool = False
    ) -> List[int]:
        """Text -> ids. Added/special tokens appearing literally in *text*
        are emitted as their single ids (the serving convention — prompts
        may carry template markers); ``bos``/``eos`` frame the result when
        the tokenizer knows those ids."""
        out: List[int] = []
        if bos:
            if self.bos_id is None:
                raise ValueError("tokenizer has no BOS token")
            out.append(self.bos_id)
        if self._added_re is not None:
            parts = self._added_re.split(text)
        else:
            parts = [text]
        for part in parts:
            if not part:
                continue
            aid = self.added_tokens.get(part)
            if aid is not None:
                out.append(aid)
            else:
                out.extend(self._encode_chunk(part))
        if eos:
            if self.eos_id is None:
                raise ValueError("tokenizer has no EOS token")
            out.append(self.eos_id)
        return out

    # -- decoding ------------------------------------------------------------

    def decode(self, ids: Iterable[int], skip_special: bool = False) -> str:
        """Ids -> text: byte-table inversion, exact for any encode output
        (byte-level BPE loses nothing). Unknown ids raise — silently
        dropping them would hide a vocab-size mismatch with the model."""
        buf: List[str] = []  # decoded segments
        pending: List[int] = []  # byte values awaiting utf-8 flush
        for i in ids:
            i = int(i)
            added = self.id_to_added.get(i)
            if added is not None:
                if pending:
                    buf.append(bytes(pending).decode("utf-8", errors="replace"))
                    pending = []
                # non-special added tokens always render; skip_special
                # strips only the special subset (BOS/EOS/markers)
                if not (skip_special and i in self._special_ids):
                    buf.append(added)
                continue
            tok = self.id_to_token.get(i)
            if tok is None:
                raise ValueError(f"id {i} is not in the vocabulary")
            pending.extend(self._byte_dec[c] for c in tok)
        if pending:
            buf.append(bytes(pending).decode("utf-8", errors="replace"))
        return "".join(buf)

    # -- corpus bridge -------------------------------------------------------

    @property
    def token_dtype_bytes(self) -> int:
        """Bytes per token id in ``encode_file`` output: 2 (uint16) when
        every id fits, else 4 — pass this to ``TokenFile(path,
        dtype_bytes=...)``; the reader's default of 2 would silently
        scramble a wide-vocab corpus (llama-3's 128k vocab needs 4)."""
        return 2 if self.vocab_size <= 65536 else 4

    def encode_file(
        self, text_path: str, out_path: str, doc_sep: str = "\n\n"
    ) -> int:
        """Tokenize a text file into the flat binary corpus format
        (``native_data.TokenFile``), BOS...EOS framing per document —
        the subword counterpart of ``ByteTokenizer.encode_file``. Open
        the result with ``TokenFile(out_path,
        dtype_bytes=tok.token_dtype_bytes)``."""
        from kubetpu_torch.jobs.native_data import write_token_file

        with open(text_path, encoding="utf-8") as f:
            text = f.read()
        ids: List[int] = []
        for doc in filter(None, text.split(doc_sep)):
            ids.extend(
                self.encode(doc, bos=self.bos_id is not None,
                            eos=self.eos_id is not None)
            )
        arr = np.asarray(ids, np.int32)
        dtype = np.uint16 if self.token_dtype_bytes == 2 else np.uint32
        write_token_file(out_path, arr, dtype=dtype)
        return int(arr.size)


def load_hf_tokenizer(path_or_dir: str) -> BpeTokenizer:
    """Load ``tokenizer.json`` from a file path or a checkpoint directory
    (the layout ``hf_import.params_from_hf`` converts from)."""
    path = path_or_dir
    if os.path.isdir(path):
        path = os.path.join(path, "tokenizer.json")
    return BpeTokenizer.from_file(path)
