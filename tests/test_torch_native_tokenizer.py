"""The port's native batch tokenizer (``csrc/host/tokenize_hash.cc``)
against the reference's ``HashTokenizer.encode_batch`` and against the
port's Python path: ids and masks equal, integer for integer."""

import numpy as np
import pytest
import xxhash

from pathway_tpu.models.tokenizer import HashTokenizer as RefTokenizer
from pathway_tpu_torch.kernels import build, host
from pathway_tpu_torch.models import tokenizer as port_tok
from pathway_tpu_torch.models._xxh3 import xxh3_64
from pathway_tpu_torch.models.tokenizer import HashTokenizer, native_xxh3_64

# every XXH3 length class (0, 1-3, 4-8, 9-16, 17-128, 129-240, > 240) and
# its edges, the 1,024-byte block edges of the long path, and the
# tokenizer's 4,096-byte scratch
_LENGTHS = sorted(set(range(0, 260)) | {511, 512, 1023, 1024, 1025, 2047, 2048, 4095, 4096, 4097, 10_000})


def _corpus(n=300, seed=0):
    rng = np.random.default_rng(seed)
    words = "Stream JOIN window index's vector_7 query 42 tensor, kernel; shard: (replica) don't 3.14 a-b".split()
    out = []
    for _ in range(n):
        k = int(rng.integers(0, 40))
        sep = rng.choice([" ", "  ", "\t", "\n", " \x1c", ",", ""], size=k)
        out.append("".join(str(words[j]) + str(s) for j, s in zip(rng.integers(0, len(words), size=k), sep)))
    return out


def _same(got, want):
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n", _LENGTHS)
def test_native_xxh3_every_length_class(n):
    data = bytes((i * 131 + n * 7 + 3) % 256 for i in range(n))
    want = xxhash.xxh3_64_intdigest(data)
    assert xxh3_64(data) == want and native_xxh3_64(data) == want


@pytest.mark.parametrize("max_length,pad_to", [(128, None), (16, None), (64, 8), (128, 200)])
def test_ascii_batches_equal_reference_and_python(max_length, pad_to):
    texts = _corpus()
    tok, ref = HashTokenizer(vocab_size=32768, max_length=max_length), RefTokenizer(32768, max_length)
    got = tok.encode_batch(texts, pad_to=pad_to)
    _same(got, ref.encode_batch(texts, pad_to=pad_to))
    _same(got, tok._encode_batch_ascii(texts, pad_to=pad_to))


def test_tokens_of_every_length_class_and_past_the_scratch():
    """Words of each hash length class, a token over the 4,096-byte
    scratch (the reference hashes it streamed), mixed case and digits."""
    words = ["".join("aB3_'"[(i + j) % 5] for j in range(n)) for i, n in enumerate(_LENGTHS) if n]
    texts = [" ".join(words[i : i + 5]) for i in range(0, len(words), 5)] + ["x" * 5000 + " Y" * 3, "A" * 4097]
    tok, ref = HashTokenizer(vocab_size=1000, max_length=512), RefTokenizer(1000, 512)
    got = tok.encode_batch(texts)
    _same(got, ref.encode_batch(texts))
    _same(got, tok._encode_batch_ascii(texts))
    assert got[0][-2, 1] == tok._word_id("x" * 5000)


def test_pad_to_shorter_than_the_longest_row_keeps_sep():
    texts = ["one two three four five six seven eight nine ten", "short"]
    tok = HashTokenizer()
    ids, mask = tok.encode_batch(texts, pad_to=6)
    assert ids.shape == (2, 6) and ids[0, 5] == tok.SEP and mask[0].sum() == 6
    _same((ids, mask), RefTokenizer().encode_batch(texts, pad_to=6))


def test_pairs_non_ascii_and_empty_take_the_python_path(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the native tokenizer ran")

    monkeypatch.setattr(port_tok, "_tokenize_native", refuse)
    tok, ref = HashTokenizer(max_length=32), RefTokenizer(max_length=32)
    texts, pairs = ["what is a shard", "Café au lait"], ["a shard holds rows", "non-ASCII ok"]
    _same(tok.encode_batch(texts, pairs=pairs), ref.encode_batch(texts, pairs=pairs))
    _same(tok.encode_batch(["naïve résumé", "plain"]), ref.encode_batch(["naïve résumé", "plain"]))
    _same(tok.encode_batch([]), ref.encode_batch([]))


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(host, "_lib", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(build.BuildError, match="not found"):
        HashTokenizer().encode_batch(["abc"])
    monkeypatch.delenv("CXX")
    monkeypatch.setattr(build, "HOST_FLAGS", build.HOST_FLAGS + ("--no-such-flag",))
    with pytest.raises(build.BuildError, match="no-such-flag"):
        HashTokenizer().encode_batch(["abc"])
    assert not list(tmp_path.glob("*.so")) and not list(tmp_path.glob("*.tmp"))


def test_build_is_content_keyed_and_atomic(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_libs", {})
    path = build.build_host("tokenize_hash")
    assert path.parent == tmp_path and path.name.startswith("tokenize_hash-host-") and path.suffix == ".so"
    assert build.build_host("tokenize_hash") == path and [p.name for p in tmp_path.iterdir()] == [path.name]
