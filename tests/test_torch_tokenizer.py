"""The port's tokenizers and host-side data (``kubetpu_torch/jobs/
tokenizer.py``, ``jobs/data.py``) against the JAX package's on the same
inputs. Ids, decoded text, corpus files and arrays must be equal exactly.

The port compiles the ``\\p{L}`` / ``\\p{N}`` / ``\\s`` patterns under the
stdlib ``re`` (``translate_pattern``); the JAX package uses the ``regex``
module. Random text is drawn from code points that Python's
``unicodedata`` assigns (categories ``Cn`` and ``Cs`` left out): on code
points only a newer Unicode assigns, the ``regex`` module's tables and
Python's may classify differently, and there the two paths may differ."""

import json
import os

import numpy as np
import pytest
import regex
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from kubetpu.jobs import data as jdata
from kubetpu.jobs import tokenizer as jtok
from kubetpu_torch.jobs import data as tdata
from kubetpu_torch.jobs import native_data as tnative
from kubetpu_torch.jobs import tokenizer as ttok

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
TOK_PATH = os.path.join(FIXDIR, "tiny_tokenizer.json")
with open(os.path.join(FIXDIR, "tiny_tokenizer_vectors.json")) as _f:
    VECTORS = json.load(_f)
with open(TOK_PATH) as _f:
    FIXTURE_PATTERN = json.load(_f)["pre_tokenizer"]["pretokenizers"][0][
        "pattern"]["Regex"]

# assigned code points only (see the module docstring); the C0 separators
# U+001C..U+001F are whitespace to str.isspace but not to \s: drawn often
TEXT = st.text(st.one_of(
    st.characters(blacklist_categories=("Cs", "Cn")),
    st.sampled_from(list(" \t\n\r\x1c\x1d\x1e\x1f\x85\xa0 'sdlLmv09Aé"))),
    max_size=60)
SETTINGS = settings(max_examples=150, deadline=None,
                    suppress_health_check=[HealthCheck.too_slow])


@pytest.fixture(scope="module")
def toks():
    return (ttok.BpeTokenizer.from_file(TOK_PATH),
            jtok.BpeTokenizer.from_file(TOK_PATH))


def test_byte_table_equals_jax():
    assert ttok.bytes_to_unicode() == jtok.bytes_to_unicode()
    assert len(set(ttok.bytes_to_unicode().values())) == 256


def test_fixture_vectors_exact(toks):
    """Every checked-in vector (made by the Rust tokenizers package)
    encodes identically, and decodes back to its text."""
    tok, jax_tok = toks
    assert len(VECTORS) >= 10
    for text, ids in VECTORS.items():
        assert tok.encode(text) == ids == jax_tok.encode(text), text
        assert tok.decode(ids) == text


@SETTINGS
@given(text=TEXT)
def test_encode_decode_equal_jax_on_random_text(toks, text):
    tok, jax_tok = toks
    ids = tok.encode(text, bos=True, eos=True)
    assert ids == jax_tok.encode(text, bos=True, eos=True)
    assert tok.decode(ids) == jax_tok.decode(ids)
    assert tok.decode(ids, skip_special=True) == text


@SETTINGS
@given(text=TEXT)
def test_gpt2_pattern_tokenizer_equals_jax(text):
    """The default (GPT-2 byte-level) pattern, over a byte vocabulary with
    a few merges, splits and encodes as the JAX package's does."""
    table = ttok.bytes_to_unicode()
    vocab = {table[b]: b for b in range(256)}
    vocab.update({"Ġt": 256, "he": 257, "Ġthe": 258})
    merges = [("Ġ", "t"), ("h", "e"), ("Ġt", "he")]
    mine = ttok.BpeTokenizer(vocab, merges, split_patterns=None)
    theirs = jtok.BpeTokenizer(vocab, merges, split_patterns=None)
    for t in (text, "the theme the\x1c the"):
        assert mine.encode(t) == theirs.encode(t)


@SETTINGS
@given(text=TEXT)
def test_stdlib_re_matches_regex_module(text):
    """The translated patterns under the stdlib ``re`` find the same spans
    as the original patterns under the ``regex`` module."""
    for pattern in (FIXTURE_PATTERN, ttok.GPT2_PATTERN):
        mine = [m.span() for m in ttok._compile(pattern).finditer(text)]
        theirs = [m.span() for m in regex.compile(pattern).finditer(text)]
        assert mine == theirs


@pytest.mark.parametrize("pattern,text", [
    (r"\p{L}+", "abcé1"), (r"[^\p{L}\p{N}]+", "ab, 12!"),
    (r"\P{N}+", "ab12cd"), (r"\s+(?!\S)|\s+", "a \x1c\x1d  b　"),
    (r"\S+", "a\x1cb c"), (r"[\s\p{N}]+", "1 2\x1f3"),
    (r"[]a]+", "]a]b"), (r"[^]a]+", "]a]bc"), (r"\p{Lu}\p{Ll}+", "Hello")])
def test_translated_classes_match_regex(pattern, text):
    assert ([m.span() for m in ttok._compile(pattern).finditer(text)]
            == [m.span() for m in regex.finditer(pattern, text)])


@pytest.mark.parametrize("pattern", [r"[\P{L}]", r"[\S]", r"\p{Foo}",
                                     r"\p{Xx}"])
def test_untranslatable_patterns_refuse(pattern):
    with pytest.raises(ValueError):
        ttok.translate_pattern(pattern)


def test_special_tokens_and_framing_equal_jax(toks):
    tok, jax_tok = toks
    for attr in ("bos_token", "eos_token", "bos_id", "eos_id", "vocab_size",
                 "token_dtype_bytes"):
        assert getattr(tok, attr) == getattr(jax_tok, attr), attr
    text = "<|begin_of_text|>hi <|end_of_text|>there"
    assert tok.encode(text) == jax_tok.encode(text)
    assert tok.encode(text)[0] == tok.bos_id
    ids = tok.encode("hi", bos=True, eos=True)
    assert tok.decode(ids, skip_special=True) == "hi"
    assert "<|begin_of_text|>" in tok.decode(ids)
    with pytest.raises(ValueError):
        tok.decode([10 ** 6])
    plain = ttok.BpeTokenizer({"a": 0}, [], split_patterns=[])
    with pytest.raises(ValueError, match="no BOS"):
        plain.encode("a", bos=True)


def test_loader_refusals_equal_jax():
    with open(TOK_PATH) as f:
        obj = json.load(f)
    cases = []
    fallback = json.loads(json.dumps(obj))
    fallback["model"]["byte_fallback"] = True
    cases.append(fallback)
    wordpiece = json.loads(json.dumps(obj))
    wordpiece["model"]["type"] = "WordPiece"
    cases.append(wordpiece)
    no_bytelevel = json.loads(json.dumps(obj))
    no_bytelevel["pre_tokenizer"] = {"type": "Whitespace"}
    cases.append(no_bytelevel)
    charlevel = json.loads(json.dumps(obj))
    charlevel["pre_tokenizer"] = None
    charlevel["decoder"] = None
    cases.append(charlevel)
    for bad in cases:
        with pytest.raises(ValueError):
            jtok.BpeTokenizer.from_json(bad)
        with pytest.raises(ValueError):
            ttok.BpeTokenizer.from_json(bad)


def test_load_hf_tokenizer_from_directory(tmp_path, toks):
    (tmp_path / "tokenizer.json").write_text(open(TOK_PATH).read())
    tok = ttok.load_hf_tokenizer(str(tmp_path))
    text = "The 1234 quick foxes"
    assert tok.encode(text) == toks[1].encode(text)


def test_bpe_encode_file_equals_jax_and_opens(tmp_path, toks):
    """The corpus file is byte-equal to the JAX package's, and opens with
    the port's TokenFile at the advertised width."""
    tok, jax_tok = toks
    src = tmp_path / "corpus.txt"
    src.write_text("the quick brown fox\n\ntpu mesh slice\n\n\n\nlast one",
                   encoding="utf-8")
    a, b = tmp_path / "port.bin", tmp_path / "jax.bin"
    n = tok.encode_file(str(src), str(a))
    assert n == jax_tok.encode_file(str(src), str(b))
    assert a.read_bytes() == b.read_bytes()
    assert tok.token_dtype_bytes == 2
    with tnative.TokenFile(str(a), dtype_bytes=tok.token_dtype_bytes) as tf:
        assert tf.num_tokens == n
        row = tf.gather(np.asarray([0]), n)[0].tolist()
    assert tok.decode(row, skip_special=True) == (
        "the quick brown foxtpu mesh slicelast one")


def test_wide_vocab_encode_file_writes_uint32(tmp_path):
    table = ttok.bytes_to_unicode()
    vocab = {**{table[b]: b for b in range(256)}, "big": 70000}
    specials = {"<s>": 70001, "</s>": 70002}
    mine = ttok.BpeTokenizer(vocab, [], special_tokens=specials,
                             bos_token="<s>", eos_token="</s>")
    theirs = jtok.BpeTokenizer(vocab, [], special_tokens=specials,
                               bos_token="<s>", eos_token="</s>")
    assert mine.token_dtype_bytes == theirs.token_dtype_bytes == 4
    src = tmp_path / "t.txt"
    src.write_text("ab c\n\nd")
    a, b = tmp_path / "a.bin", tmp_path / "b.bin"
    n = mine.encode_file(str(src), str(a))
    theirs.encode_file(str(src), str(b))
    assert a.read_bytes() == b.read_bytes() and a.stat().st_size == 4 * n
    with tnative.TokenFile(str(a), dtype_bytes=4) as tf:
        assert tf.gather(np.asarray([0]), 1)[0, 0] == 70001


@SETTINGS
@given(text=TEXT)
def test_byte_tokenizer_equals_jax(text):
    mine, theirs = tdata.ByteTokenizer(), jdata.ByteTokenizer()
    for bos in (False, True):
        ids = mine.encode(text, bos=bos, eos=not bos)
        assert ids == theirs.encode(text, bos=bos, eos=not bos)
        assert mine.decode(ids) == theirs.decode(ids) == text
    assert mine.vocab == 258 and (mine.BOS, mine.EOS) == (256, 257)


def test_byte_encode_file_equals_jax(tmp_path):
    """The numpy-assembled corpus is byte-equal to the JAX package's
    per-id list, documents framed BOS...EOS, empty documents dropped."""
    rng = np.random.default_rng(0)
    words = ["alpha", "béta", "gamma", "δelta", "x", "🚀"]
    docs = [" ".join(rng.choice(words, rng.integers(1, 30)))
            for _ in range(40)]
    src = tmp_path / "c.txt"
    src.write_text("\n\n".join(docs) + "\n\n\n\n", encoding="utf-8")
    a, b = tmp_path / "a.bin", tmp_path / "b.bin"
    n = tdata.ByteTokenizer().encode_file(str(src), str(a))
    assert n == jdata.ByteTokenizer().encode_file(str(src), str(b))
    assert a.read_bytes() == b.read_bytes() and a.stat().st_size == 2 * n
    empty = tmp_path / "e.txt"
    empty.write_text("\n\n")
    assert tdata.ByteTokenizer().encode_file(str(empty), str(a)) == 0
    assert a.stat().st_size == 0


@pytest.mark.parametrize("rate", [0.15, 0.01])
def test_mlm_batches_equal_jax(rate):
    mine = tdata.mlm_batches(tdata.SyntheticCorpus(50, seed=3), 4, 16,
                             mask_rate=rate, seed=2)
    theirs = jdata.mlm_batches(jdata.SyntheticCorpus(50, seed=3), 4, 16,
                               mask_rate=rate, seed=2)
    for _ in range(3):
        (t, m), (jt, jm) = next(mine), next(theirs)
        assert t.tobytes() == jt.tobytes() and m.tobytes() == jm.tobytes()
        assert m.any(axis=1).all()


def test_synthetic_images_equal_jax():
    mine = tdata.SyntheticImages(image_size=8, n_classes=5, seed=4)
    theirs = jdata.SyntheticImages(image_size=8, n_classes=5, seed=4)
    it, jt = mine.batches(6, seed=1, noise=0.2), theirs.batches(6, seed=1,
                                                               noise=0.2)
    for _ in range(3):
        (x, y), (jx, jy) = next(it), next(jt)
        assert x.dtype == np.float32 and y.dtype == np.int32
        assert x.tobytes() == jx.tobytes() and y.tobytes() == jy.tobytes()
