"""Port parity: the pure-Python XXH3-64 and ``HashTokenizer`` of
``pathway_tpu_torch`` against the ``xxhash`` package and the reference
tokenizer.  Integer outputs, so equality is exact."""

import numpy as np
import xxhash
from hypothesis import given, settings
from hypothesis import strategies as st

from pathway_tpu.models.tokenizer import HashTokenizer as RefTokenizer
from pathway_tpu_torch.models._xxh3 import xxh3_64
from pathway_tpu_torch.models.tokenizer import HashTokenizer

# every length class of XXH3-64: 0, 1-3, 4-8, 9-16, 17-128, 129-240, >240
# (one and several 1024-byte blocks, partial stripes)
_LENGTHS = [0, 1, 2, 3, 4, 7, 8, 9, 15, 16, 17, 32, 33, 64, 65, 96, 97, 128,
            129, 200, 240, 241, 255, 256, 1024, 1025, 2048, 2500]


def test_xxh3_every_length_class():
    rng = np.random.default_rng(0)
    for n in _LENGTHS:
        for _ in range(3):
            data = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
            assert xxh3_64(data) == xxhash.xxh3_64_intdigest(data), n


@settings(max_examples=200, deadline=None)
@given(st.binary(min_size=0, max_size=600))
def test_xxh3_matches_xxhash(data):
    assert xxh3_64(data) == xxhash.xxh3_64_intdigest(data)


_ASCII = [
    "Hello, world! It's a test.",
    "",
    "tokens_with_underscores and 12345 numbers; (punctuation)...",
    "word " * 200,  # truncated at max_length
    "MiXeD CaSe words hash like lower case words",
]
_NON_ASCII = [
    "Grüße aus Köln — naïve café",
    "日本語のテキスト and ascii",
    "emoji 🎉 party",
]


def _assert_same(texts, **kw):
    ref_ids, ref_mask = RefTokenizer().encode_batch(texts, **kw)
    ids, mask = HashTokenizer().encode_batch(texts, **kw)
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_array_equal(mask, ref_mask)
    assert ids.dtype == ref_ids.dtype == np.int32


def test_encode_batch_ascii_matches_reference():
    _assert_same(_ASCII)
    _assert_same(_ASCII, pad_to=128)
    _assert_same(_ASCII, pad_to=8)  # rows cut by pad_to still end in SEP
    _assert_same(_ASCII, max_length=16)


def test_encode_batch_non_ascii_matches_reference():
    _assert_same(_NON_ASCII)
    _assert_same(_NON_ASCII + _ASCII)
    # a pad_to shorter than a row: the reference's Python path cuts the SEP
    _assert_same(_NON_ASCII, pad_to=4)
    _assert_same(_NON_ASCII + _ASCII, pad_to=8)


def test_encode_pairs_match_reference():
    ref = RefTokenizer(max_length=16)
    port = HashTokenizer(max_length=16)
    a, b = _ASCII[3], _NON_ASCII[0]
    assert port.encode(a, b) == ref.encode(a, b)
    r_ids, r_mask = ref.encode_batch([a, b], pairs=[b, a])
    p_ids, p_mask = port.encode_batch([a, b], pairs=[b, a])
    np.testing.assert_array_equal(p_ids, r_ids)
    np.testing.assert_array_equal(p_mask, r_mask)


def test_word_memo_is_bounded():
    tok = HashTokenizer()
    tok._MEMO_MAX = 4
    ids = tok.tokenize("a b c d e f g a")
    assert len(tok._memo) <= 4
    assert ids == RefTokenizer().tokenize("a b c d e f g a")
