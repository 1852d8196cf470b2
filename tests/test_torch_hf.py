"""Port parity of the real-weights path on the CPU: local HF BERT
checkpoints built here with ``transformers`` (tiny, seeded), read by the
port's safetensors reader, tokenized by its ``WordPieceTokenizer``, run
through its ``BertEncoderModule`` / ``BertCrossEncoderModule``, and served
by ``SentenceEncoder`` / ``CrossEncoderModel`` -> ``FusedEncodeSearch``
(exact and IVF) -> ``RetrieveRerankPipeline`` (the host-sorted stage 2)
-> ``ServeScheduler``, each against ``pathway_tpu`` and, where one
exists, against ``transformers``.  Then the port's own checkpoints
against the reference's orbax ones.

Tolerances: f32 throughout (the HF path computes in the checkpoint's
dtype); embeddings, hidden states and scores within 1e-5; token ids,
keys and flags equal (a key swap only between scores tied within 1e-5).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.numpy as st_np
import torch
from transformers import BertConfig as HfConfig
from transformers import BertForSequenceClassification, BertModel, BertTokenizer

from pathway_tpu.models import hf_import as ref_hf
from pathway_tpu.models.cross_encoder import CrossEncoderModel as RefCrossEncoder
from pathway_tpu.models.encoder import SentenceEncoder as RefEncoder
from pathway_tpu.models.wordpiece import WordPieceTokenizer as RefWordPiece
from pathway_tpu.ops.ivf import IvfKnnIndex as RefIvf
from pathway_tpu.ops.knn import DeviceKnnIndex as RefKnn
from pathway_tpu.ops.retrieve_rerank import RetrieveRerankPipeline as RefPipeline
from pathway_tpu.ops.serving import FusedEncodeSearch as RefServe
from pathway_tpu.robust import CircuitBreaker as RefBreaker
from pathway_tpu.robust import inject as ref_inject
from pathway_tpu_torch import observe
from pathway_tpu_torch.index import ForwardIndex
from pathway_tpu_torch.models import hf_import, safetensors
from pathway_tpu_torch.models.cross_encoder import CrossEncoderModel
from pathway_tpu_torch.models.encoder import CHECKPOINT_FILE, SentenceEncoder
from pathway_tpu_torch.models.wordpiece import WordPieceTokenizer
from pathway_tpu_torch.observe import hbm
from pathway_tpu_torch.ops import dispatch_counter
from pathway_tpu_torch.ops.ivf import IvfKnnIndex
from pathway_tpu_torch.ops.knn import DeviceKnnIndex
from pathway_tpu_torch.ops.retrieve_rerank import RetrieveRerankPipeline
from pathway_tpu_torch.ops.serving import FusedEncodeSearch
from pathway_tpu_torch.robust import CircuitBreaker, inject
from pathway_tpu_torch.serve import ServeScheduler

from .test_torch_ivf import assert_same_ranking

ATOL = 1e-5
TIMEOUT = 60
WORDS = (
    "the cat sat on mat dog chas ball fish swim in sea stream data index live quer un "
    "query kernel shard probe cluster vector serve batch token cache commit window join "
    "cafe naive resume tokyo 東 京 你 好"
).split()
PIECES = ["##ed", "##ing", "##flow", "##es", "##y", "##believ", "##able", "##s", "##er"]
PUNCT = [".", ",", "!", "?", "'", "-", "(", ")"]
CASED = ["The", "Cat", "Café", "Tokyo", "Data"]
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS + PIECES + PUNCT + CASED
HIDDEN = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _disarmed():
    yield
    inject.disarm()
    ref_inject.disarm()


def _hf_config(**kw):
    return HfConfig(
        vocab_size=len(VOCAB), hidden_size=HIDDEN, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, max_position_embeddings=64, **kw,
    )


def _write_vocab(d, vocab=VOCAB):
    with open(os.path.join(d, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """A ``BertModel`` export (the sentence-transformers embedder layout)."""
    d = str(tmp_path_factory.mktemp("bert"))
    torch.manual_seed(0)
    BertModel(_hf_config()).eval().save_pretrained(d, safe_serialization=True)
    _write_vocab(d)
    return d


@pytest.fixture(scope="module")
def hf_cross_dir(tmp_path_factory):
    """A ``BertForSequenceClassification`` export with one label (the
    cross-encoder layout; its tensors carry the ``bert.`` prefix)."""
    d = str(tmp_path_factory.mktemp("bert_cross"))
    torch.manual_seed(1)
    BertForSequenceClassification(_hf_config(num_labels=1)).eval().save_pretrained(d, safe_serialization=True)
    _write_vocab(d)
    return d


def _docs(n, seed=5):
    rng = np.random.default_rng(seed)
    return {i: " ".join(rng.choice(WORDS[:30], size=int(rng.integers(3, 12))).tolist()) for i in range(n)}


DOCS = _docs(64)
QUERIES = ["the cat sat on the mat", "fish swim in the sea", "vector index query", "kernel shard probe cluster"]


# -- safetensors reader / writer -------------------------------------------------------


def test_reader_matches_library_on_save_pretrained(hf_dir, hf_cross_dir):
    for d in (hf_dir, hf_cross_dir):
        path = os.path.join(d, "model.safetensors")
        want, got = st_np.load_file(path), safetensors.load_file(path)
        assert sorted(got) == sorted(want)
        for name in want:
            assert got[name].dtype == want[name].dtype and np.array_equal(got[name], want[name]), name
        assert safetensors.load_file_with_metadata(path)[1] == {"format": "pt"}


@pytest.mark.parametrize("dtype_name", sorted(safetensors._DTYPES))
def test_reader_maps_every_dtype_as_library(tmp_path, dtype_name):
    dtype = np.dtype(safetensors._DTYPES[dtype_name])
    rng = np.random.default_rng(len(dtype_name))
    arrays = {
        "a": (rng.standard_normal((3, 5)) * 50).astype(dtype),
        "b": (rng.standard_normal((2, 1, 4)) * 50).astype(dtype),
        "empty": np.zeros((0, 3), dtype),
    }
    path = str(tmp_path / "x.safetensors")
    st_np.save_file(arrays, path)
    got = safetensors.load_file(path)
    for name, want in st_np.load_file(path).items():
        assert got[name].dtype == want.dtype == dtype and got[name].shape == want.shape
        assert np.array_equal(got[name], want)


def test_reader_refuses_bf16(tmp_path):
    from safetensors.torch import save_file as torch_save

    path = str(tmp_path / "bf16.safetensors")
    torch_save({"w": torch.ones(2, 3, dtype=torch.bfloat16)}, path)
    # the library maps BF16 only where ml_dtypes has given numpy a
    # bfloat16 (JAX's process) and raises TypeError elsewhere; the port's
    # reader raises, and never widens the tensor
    with pytest.raises(TypeError, match="BF16"):
        safetensors.load_file(path)


def test_writer_reads_back_through_library(tmp_path):
    rng = np.random.default_rng(3)
    arrays = {
        "f32": rng.standard_normal((4, 3)).astype(np.float32),
        "i64": rng.integers(-9, 9, (5,)),
        "u8": rng.integers(0, 255, (2, 2)).astype(np.uint8),
        "bool": rng.random((3,)) > 0.5,
        "scalar": np.float32(2.5),
        "strided": rng.standard_normal((6, 4))[::2, ::-1],
        "big_endian": np.arange(6, dtype=">i4").reshape(2, 3),
        "f16": np.arange(6, dtype=np.float16).reshape(3, 2),
    }
    path = str(tmp_path / "w.safetensors")
    safetensors.save_file(arrays, path, metadata={"format": "test", "n": 8})
    back = st_np.load_file(path)
    assert sorted(back) == sorted(arrays)
    for name, value in arrays.items():
        want = np.asarray(value)
        assert np.array_equal(back[name], want) and back[name].shape == want.shape, name
    assert safetensors.load_file_with_metadata(path)[1] == {"format": "test", "n": "8"}
    with pytest.raises(TypeError):
        safetensors.save_file({"x": np.array(["a"])}, str(tmp_path / "bad.safetensors"))


# -- WordPiece ---------------------------------------------------------------------------

TOKENIZER_TEXTS = [
    "The cat sat on the mat.",
    "a dog chased the ball!",
    "unbelievable streaming dataflow indexes",
    "Café naïve résumé, TOKYO data",
    "東京 你好 mixed你text",
    "the\x00 cat\x07 sat� on\tthe\nmat\r\nnow",
    "x" * 101 + " cat " + "y" * 100,
    "",
    "   ",
]


@pytest.mark.parametrize("lowercase", [True, False])
@pytest.mark.parametrize("text", TOKENIZER_TEXTS)
def test_wordpiece_matches_reference_and_transformers(hf_dir, text, lowercase):
    vf = os.path.join(hf_dir, "vocab.txt")
    ours = WordPieceTokenizer(vf, max_length=32, lowercase=lowercase)
    ref = RefWordPiece(vf, max_length=32, lowercase=lowercase)
    theirs = BertTokenizer(vf, do_lower_case=lowercase)
    want = theirs(text)["input_ids"][:31]
    want = want if want[-1] == ours.SEP else want + [ours.SEP]
    assert ours.encode(text) == ref.encode(text) == want, repr(text)
    assert ours.tokenize(text) == ref.tokenize(text)


def test_wordpiece_pairs_truncate_longest_first(hf_dir):
    vf = os.path.join(hf_dir, "vocab.txt")
    ours, ref = WordPieceTokenizer(vf, max_length=16), RefWordPiece(vf, max_length=16)
    theirs = BertTokenizer(vf)
    long_a = " ".join(WORDS[:14])
    long_b = " ".join(WORDS[10:30])
    short_a = " ".join(WORDS[:5])
    for a, b in ((long_a, long_b), ("cat", long_b), (long_a, "dog"), ("cat", "dog"), (short_a, long_b)):
        want = theirs(a, b, truncation="longest_first", max_length=16)["input_ids"]
        got = ours.encode(a, b)
        assert got == ref.encode(a, b) and len(got) == len(want) <= 16, (a, b)
        if a is long_a and b is long_b:
            # both cut to one length: the reference pops the first segment
            # on a tie where transformers pops the second (13 = 6 + 7 here,
            # 7 + 6 there); the port keeps the reference's split
            assert got[:7] == want[:7] and got.index(ours.SEP) == 7 == want.index(ours.SEP) - 1
        else:
            assert got == want, (a, b)
    ids, mask = ours.encode_batch([long_a, "cat"], pairs=[long_b, "dog"])
    ref_ids, ref_mask = ref.encode_batch([long_a, "cat"], pairs=[long_b, "dog"])
    assert np.array_equal(ids, ref_ids) and np.array_equal(mask, ref_mask) and ids.shape == (2, 16)


def test_wordpiece_batch_padding_and_blank_vocab_lines(tmp_path):
    # blank lines keep their line numbers and map no token
    vocab = ["[PAD]", "[UNK]", "", "[CLS]", "[SEP]", "", "", "cat", "sat", "##s"]
    vf = tmp_path / "vocab.txt"
    vf.write_text("\n".join(vocab) + "\n")
    ours, ref = WordPieceTokenizer(str(vf), max_length=40), RefWordPiece(str(vf), max_length=40)
    assert ours.vocab == ref.vocab and ours.vocab_size == ref.vocab_size == 10
    assert (ours.CLS, ours.SEP) == (3, 4) and ours.encode("cats sat dog") == [3, 7, 9, 8, 1, 4]
    assert ours.encode("cats sat dog") == BertTokenizer(str(vf))("cats sat dog")["input_ids"]
    texts = ["cat " * n for n in (1, 14, 20)]
    for pad_to in (None, 24):
        for got, want in zip(ours.encode_batch(texts, pad_to=pad_to), ref.encode_batch(texts, pad_to=pad_to)):
            assert np.array_equal(got, want) and got.dtype == want.dtype
    assert ours.encode_batch(texts)[0].shape == (3, 32)  # min(40, 16 * ceil(22 / 16))
    assert ours.encode_batch(texts[:1])[0].shape == (1, 16)
    with pytest.raises(FileNotFoundError):
        WordPieceTokenizer(str(tmp_path / "absent.txt"))


# -- the BERT forward ----------------------------------------------------------------------


def _batch(seed=1, B=3, L=12):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, len(VOCAB), (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, 8:] = 0
    mask[2, 5:] = 0
    ids[mask == 0] = 0
    type_ids = ((np.arange(L)[None, :] >= 4) & (mask > 0)).astype(np.int32)
    return ids, mask, type_ids


def _encoder_module(path):
    module, config, tokenizer = hf_import.load_hf_text_model(path, 32, torch.bfloat16)
    return module, config, tokenizer


def test_bert_forward_and_mean_pool_match_reference_and_transformers(hf_dir):
    ids, mask, type_ids = _batch()
    module, config, _ = _encoder_module(hf_dir)
    assert config.dtype == torch.bfloat16 and all(p.dtype == torch.float32 for p in module.parameters())
    ref_cfg, ref_params = ref_hf.load_bert_checkpoint(hf_dir)
    model = BertModel.from_pretrained(hf_dir).eval()
    for t in (None, type_ids):
        with torch.no_grad():
            got = hf_import.bert_forward(module, torch.from_numpy(ids), torch.from_numpy(mask),
                                         None if t is None else torch.from_numpy(t))
            theirs = model(
                input_ids=torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask).long(),
                token_type_ids=None if t is None else torch.from_numpy(t).long(),
            ).last_hidden_state.numpy()
        got = got.numpy()
        want = np.asarray(ref_hf.bert_forward(ref_params, ids, mask, ref_cfg, None if t is None else t))
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
        np.testing.assert_allclose(got[mask > 0], theirs[mask > 0], atol=ATOL, rtol=0)
    want = np.array(ref_hf.bert_forward(ref_params, ids, mask, ref_cfg))
    with torch.no_grad():
        pooled = hf_import.mean_pool(torch.from_numpy(want), torch.from_numpy(mask)).numpy()
        empty = hf_import.mean_pool(torch.ones(1, 4, HIDDEN), torch.zeros(1, 4, dtype=torch.int32))
        module_out = module(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(pooled, np.asarray(ref_hf.mean_pool(want, mask)), atol=ATOL, rtol=0)
    np.testing.assert_allclose(module_out, pooled, atol=ATOL, rtol=0)
    assert torch.equal(empty, torch.zeros(1, HIDDEN))  # the count clamps at 1e-9, not at 1


def test_bert_prefix_missing_tensor_missing_vocab_and_clamp(hf_dir, hf_cross_dir, tmp_path):
    # the classification export's ``bert.`` prefix is stripped
    cfg, sd = hf_import.load_bert_checkpoint(hf_cross_dir)
    raw = st_np.load_file(os.path.join(hf_cross_dir, "model.safetensors"))
    assert np.array_equal(sd["layers.1.ffn_out.weight"].numpy(), raw["bert.encoder.layer.1.output.dense.weight"])
    assert cfg == hf_import.BertConfig(len(VOCAB), HIDDEN, 2, 4, 64, 64)
    # a missing tensor: the reference's KeyError text
    bad = tmp_path / "bad"
    bad.mkdir()
    tensors = st_np.load_file(os.path.join(hf_dir, "model.safetensors"))
    del tensors["encoder.layer.1.attention.self.key.bias"]
    safetensors.save_file(tensors, str(bad / "model.safetensors"))
    with open(os.path.join(hf_dir, "config.json")) as f:
        (bad / "config.json").write_text(f.read())
    with pytest.raises(KeyError) as ours:
        hf_import.load_bert_checkpoint(str(bad))
    with pytest.raises(KeyError) as ref:
        ref_hf.load_bert_checkpoint(str(bad))
    assert str(ours.value) == str(ref.value) and "encoder.layer.1.attention.self.key.bias" in str(ours.value)
    # an embedder export has no classification head
    with pytest.raises(KeyError, match="classification head"):
        hf_import.load_bert_cross_encoder(hf_dir)
    # weights without a vocab: FileNotFoundError, as the reference
    novocab = tmp_path / "novocab"
    novocab.mkdir()
    for name in ("config.json", "model.safetensors"):
        with open(os.path.join(hf_dir, name), "rb") as f:
            (novocab / name).write_bytes(f.read())
    assert hf_import.is_hf_checkpoint(str(novocab)) and not hf_import.is_hf_checkpoint(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="vocab.txt"):
        SentenceEncoder(checkpoint_path=str(novocab), device="cpu")
    with pytest.raises(FileNotFoundError, match="vocab.txt"):
        RefEncoder(checkpoint_path=str(novocab))
    # max_length clamps to max_position_embeddings
    enc = SentenceEncoder(checkpoint_path=hf_dir, max_length=1000, device="cpu")
    ref = RefEncoder(checkpoint_path=hf_dir, max_length=1000)
    assert enc.config.max_len == ref.config.max_len == enc.tokenizer.max_length == 64


# -- SentenceEncoder -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def encoders(hf_dir):
    """The reference's and the port's encoder over one checkpoint, both at
    their default (bf16) dtype, which the HF path must not use."""
    return RefEncoder(checkpoint_path=hf_dir, max_length=32), SentenceEncoder(
        checkpoint_path=hf_dir, max_length=32, device="cpu"
    )


def test_sentence_encoder_matches_reference(encoders):
    ref, enc = encoders
    assert isinstance(enc.module, hf_import.BertEncoderModule) and enc.hf
    assert isinstance(enc.tokenizer, WordPieceTokenizer)
    assert enc.get_embedding_dimension() == HIDDEN
    texts = QUERIES + list(DOCS.values())[:20] + ["", "unknownword"]
    want = ref.encode(texts)
    got = enc.encode(texts)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(enc.encode_to_device(texts).numpy(), want, atol=ATOL, rtol=0)
    # packing is a shape optimization the HF module does not take
    np.testing.assert_allclose(enc.encode_packed_to_device(texts).numpy(), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        np.asarray(ref.encode_packed_to_device(texts)), want, atol=ATOL, rtol=0
    )


def test_sentence_encoder_token_states_raise_and_operator_plane(encoders):
    ref, enc = encoders
    with pytest.raises(NotImplementedError):
        ref.encode_token_states(["the cat"])
    with pytest.raises(NotImplementedError):
        enc.encode_token_states(["the cat"])
    tokens, mask, n = enc.encode_token_states([])
    assert n == 0 and tokens.shape == (0, 32, HIDDEN)
    # a forward index over an HF encoder fails its plan, counted, as the reference
    fwd = ForwardIndex(enc, tokens_per_doc=4)
    assert fwd.add([1, 2], ["the cat", "dog"]) == 0 and fwd.stats["absorb_failures"] == 1
    # the ledger counts the module; the tripwire saw the (batch, length) keys
    n_bytes = sum(p.numel() * p.element_size() for p in enc.module.parameters())
    assert hbm.sample()["subsystems"]["params"].get("encoder", 0) >= n_bytes
    enc.encode(["the cat sat"] * 5)
    assert (16, 16) in enc._tripwire._sigs


def test_sentence_encoder_dispatch_retry_covers_hf(encoders, monkeypatch):
    _, enc = encoders
    want = enc.encode(QUERIES)
    retries = observe.counter("pathway_robust_retries_total", site="encoder.dispatch")
    before = retries.value
    monkeypatch.setenv("PATHWAY_RETRY_BASE_MS", "0")
    with inject.armed("encoder.dispatch", "raise", times=1):
        got = enc.encode(QUERIES)
    assert np.array_equal(got, want) and retries.value - before == 1


# -- CrossEncoderModel -------------------------------------------------------------------------

PAIRS = [
    ("the cat sat", "a dog chased the ball"),
    ("fish swim", "the cat sat on the mat"),
    ("live query", "streaming dataflow indexes"),
    ("the cat sat on the mat " * 4, "fish swim in the sea " * 5),
    ("", "cat"),
]


@pytest.fixture(scope="module")
def cross_encoders(hf_cross_dir):
    return RefCrossEncoder(checkpoint_path=hf_cross_dir, max_length=32), CrossEncoderModel(
        checkpoint_path=hf_cross_dir, max_length=32, device="cpu"
    )


def test_cross_encoder_matches_reference_and_transformers(cross_encoders, hf_cross_dir):
    ref, ce = cross_encoders
    assert ce._hf and isinstance(ce.module, hf_import.BertCrossEncoderModule) and ce.module.pooler is not None
    want = ref.predict(PAIRS)
    for packed in (None, True, False):  # an HF module scores unpacked whatever it is asked
        got = ce.predict(PAIRS, packed=packed)
        assert got.dtype == np.float32 and got.shape == (len(PAIRS),)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # transformers on the same ids, mask and segments
    tok = BertTokenizer(os.path.join(hf_cross_dir, "vocab.txt"))
    model = BertForSequenceClassification.from_pretrained(hf_cross_dir).eval()
    enc = tok([q for q, _ in PAIRS], [d for _, d in PAIRS], truncation="longest_first", max_length=32,
              padding=True, return_tensors="pt")
    with torch.no_grad():
        theirs = model(**enc).logits[:, 0].numpy()
    np.testing.assert_allclose(got, theirs, atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="not an HF cross-encoder"):
        CrossEncoderModel(checkpoint_path=os.path.dirname(hf_cross_dir), device="cpu")


# -- the pipeline, the scheduler and the token export ---------------------------------------------


@pytest.fixture(scope="module")
def stack(encoders, cross_encoders):
    ref_enc, enc = encoders
    ref_ce, ce = cross_encoders
    keys = sorted(DOCS)
    vecs = ref_enc.encode([DOCS[k] for k in keys])
    ref_exact = RefKnn(HIDDEN, initial_capacity=128)
    ref_exact.add(keys, vecs)
    exact = DeviceKnnIndex(HIDDEN, initial_capacity=128, device="cpu")
    exact.add(keys, vecs)
    ref_ivf = RefIvf(HIDDEN, n_clusters=4, seed=3)
    ref_ivf.add(keys, vecs)
    ref_ivf.build()
    ivf = IvfKnnIndex(HIDDEN, n_clusters=4, seed=3, device="cpu")
    ivf.load_warm_state(ref_ivf.warm_state())
    return {"ref": (ref_enc, ref_ce, ref_exact, ref_ivf), "port": (enc, ce, exact, ivf)}


def _pipes(stack, kind, **kw):
    out = []
    for side, serve_cls, pipe_cls, breaker_cls in (
        ("ref", RefServe, RefPipeline, RefBreaker), ("port", FusedEncodeSearch, RetrieveRerankPipeline, CircuitBreaker)
    ):
        enc, ce, exact, ivf = stack[side]
        sk = {"embed_cache": None} if side == "ref" else {}
        serve = serve_cls(enc, exact if kind == "exact" else ivf, k=8, **sk)
        pipe = pipe_cls(serve, ce, DOCS, k=5, candidates=12, **kw)
        pipe._breaker = breaker_cls(f"hf-{kind}-{side}", failure_threshold=1000)
        out.append(pipe)
    return out


def _assert_same_serve(want, got):
    assert len(got) == len(want) and got.degraded == want.degraded
    for w, g in zip(want, got):
        assert_same_ranking(list(w), list(g), atol=ATOL)


@pytest.mark.parametrize("kind", ["exact", "ivf"])
def test_hf_pipeline_matches_reference(stack, kind):
    ref, port = _pipes(stack, kind)
    want = ref(QUERIES)
    with dispatch_counter.DispatchCounter() as counter:
        got = port(QUERIES)
    assert got.ok and all(row for row in got)
    _assert_same_serve(want, got)
    tag = "serve_exact" if kind == "exact" else "serve_ivf"
    assert [t for _, t in counter.events] == [tag, tag, "rerank_stage2_host", "rerank_stage2_host"]
    # the rerank scores are the cross-encoder's own scores of those pairs
    _, ce = stack["port"][:2]
    for q, row in zip(QUERIES, got):
        scores = ce.predict([(q, DOCS[key]) for key, _ in row])
        np.testing.assert_allclose([s for _, s in row], scores, atol=ATOL, rtol=0)


def test_hf_stage2_host_sort_is_stable(stack):
    """Tied scores keep stage-1 order: every candidate's text is the same,
    so all scores tie and the rows keep the stage-1 ranking."""
    enc, ce, exact, _ = stack["port"]
    same = {k: "the cat sat" for k in DOCS}
    pipe = RetrieveRerankPipeline(FusedEncodeSearch(enc, exact, k=8), ce, same, k=6, candidates=12)
    pipe._breaker = CircuitBreaker("hf-stable", failure_threshold=1000)
    got = pipe(QUERIES)
    stage1 = pipe.retriever(QUERIES, 12)
    for row, s1 in zip(got, stage1):
        assert [k for k, _ in row] == [k for k, _ in s1[:6]]
        assert len({s for _, s in row}) == 1


def test_hf_outer_retry_counts_one_attempt_per_serve(stack, monkeypatch):
    ref, port = _pipes(stack, "exact")
    clean = port(QUERIES)
    trails = []
    for pipe, mod in ((ref, ref_inject), (port, inject)):
        pipe._breaker = (RefBreaker if pipe is ref else CircuitBreaker)(f"hf-outer-{id(pipe)}", failure_threshold=100)
        trail = []
        with mod.armed("rerank.dispatch", "raise"):
            for _ in range(2):
                fired = mod.fired_count("rerank.dispatch")
                got = pipe(QUERIES)
                trail.append((got.degraded, mod.fired_count("rerank.dispatch") - fired, pipe._breaker._failures))
        trails.append(trail)
    assert trails[0] == trails[1]
    assert [t[1] for t in trails[1]] == [1, 1]  # _OUTER_RETRY: one attempt per serve
    assert all(t[0] == ("rerank_skipped",) for t in trails[1])
    # a transient fault at the model's own dispatch retries inside it
    monkeypatch.setenv("PATHWAY_RETRY_BASE_MS", "0")
    with inject.armed("cross_encoder.dispatch", "raise", times=1):
        got = port(QUERIES)
    assert got.ok and got == clean


def test_hf_scheduler_matches_solo_and_exports_no_tokens(stack, hf_dir):
    _, port = _pipes(stack, "ivf")
    solo = {q: port([q]) for q in QUERIES}
    with ServeScheduler(port, window_us=300_000, result_cache=None) as sched:
        tickets = [sched.submit([q]) for q in QUERIES]
        results = [t.result(timeout=TIMEOUT) for t in tickets]
    for q, got in zip(QUERIES, results):
        assert got.degraded == ()
        assert_same_ranking(list(solo[q][0]), list(got[0]), atol=ATOL)
    # an HF trunk exports no query token states, as the reference
    enc, _, exact, _ = stack["port"]
    ref_enc, _, ref_exact, _ = stack["ref"]
    serve = FusedEncodeSearch(enc, exact, k=4, export_query_tokens=True)
    ref_serve = RefServe(ref_enc, ref_exact, k=4, export_query_tokens=True, embed_cache=None)
    assert not serve._exporting() and not ref_serve._exporting()
    handle = serve.submit(QUERIES)
    assert handle.query_tokens is None
    _assert_same_serve(ref_serve(QUERIES), handle())
    # so a MaxSim stage cannot be built over it
    with pytest.raises(ValueError, match="query token states"):
        RetrieveRerankPipeline(serve, doc_text=DOCS, forward_index=ForwardIndex(enc))


# -- checkpoints ---------------------------------------------------------------------------------

ENC = dict(dimension=32, n_layers=2, n_heads=4, max_length=32, vocab_size=512)


def test_orbax_checkpoint_restored_by_reference_and_bridged(tmp_path):
    pytest.importorskip("orbax.checkpoint")
    path = str(tmp_path / "orbax")
    RefEncoder(dtype=jnp.float32, seed=7, **ENC).save_checkpoint(path)
    restored = RefEncoder(dtype=jnp.float32, checkpoint_path=path, **ENC)
    tree = jax.tree_util.tree_map(np.asarray, restored.params)
    enc = SentenceEncoder(dtype=torch.float32, device="cpu", params=tree, **ENC)
    np.testing.assert_allclose(enc.encode(QUERIES), restored.encode(QUERIES), atol=ATOL, rtol=0)
    # the port cannot read orbax: an error naming both formats, never a seeded init
    with pytest.raises(ValueError, match="neither an HF checkpoint.*nor a pathway_tpu_torch checkpoint"):
        SentenceEncoder(checkpoint_path=path, device="cpu", **ENC)


def test_port_checkpoint_round_trip(tmp_path):
    enc = SentenceEncoder(dtype=torch.float32, seed=7, device="cpu", **ENC)
    path = str(tmp_path / "port")
    enc.save_checkpoint(path)
    assert os.listdir(path) == [CHECKPOINT_FILE] and not hf_import.is_hf_checkpoint(path)
    back = SentenceEncoder(dtype=torch.float32, seed=99, device="cpu", checkpoint_path=path, **ENC)
    want, got = enc.module.state_dict(), back.module.state_dict()
    assert sorted(want) == sorted(got) and all(torch.equal(want[k], got[k]) for k in want)
    assert np.array_equal(back.encode(QUERIES), enc.encode(QUERIES))
    # the state dict is f32 whatever the compute dtype
    bf16 = SentenceEncoder(seed=7, device="cpu", checkpoint_path=path, **ENC)
    assert all(torch.equal(want[k], v) for k, v in bf16.module.state_dict().items())
    with pytest.raises(ValueError, match="saved for"):
        SentenceEncoder(device="cpu", checkpoint_path=path, **{**ENC, "n_heads": 2})
    with pytest.raises(ValueError, match="neither an HF checkpoint"):
        SentenceEncoder(device="cpu", checkpoint_path=str(tmp_path / "absent"), **ENC)
    with pytest.raises(ValueError, match="own checkpoint directory"):
        SentenceEncoder(checkpoint_path=_tiny_hf(tmp_path), device="cpu").save_checkpoint(str(tmp_path / "x"))


def _tiny_hf(tmp_path):
    d = str(tmp_path / "tiny_hf")
    torch.manual_seed(2)
    BertModel(_hf_config()).eval().save_pretrained(d, safe_serialization=True)
    _write_vocab(d)
    return d


@pytest.mark.parametrize("n_labels,pooler", [(None, True), (1, True), (3, False)])
def test_written_checkpoint_loads_in_transformers_and_both_packages(tmp_path, n_labels, pooler):
    """``write_bert_checkpoint`` (the card smoke's weights, written with
    the port's writer): transformers, the reference and the port read it
    and agree within 1e-5."""
    cfg = hf_import.BertConfig(len(VOCAB), HIDDEN, 2, 4, 64, 64)
    d = str(tmp_path / "written")
    hf_import.write_bert_checkpoint(d, cfg, VOCAB, seed=3, n_labels=n_labels, pooler=pooler)
    assert hf_import.is_hf_checkpoint(d)
    ids, mask, type_ids = _batch(seed=4)
    t = dict(input_ids=torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask).long(),
             token_type_ids=torch.from_numpy(type_ids).long())
    if n_labels is None:
        with torch.no_grad():
            theirs = BertModel.from_pretrained(d).eval()(**t).last_hidden_state.numpy()
        module, _, _ = hf_import.load_hf_text_model(d, 32, torch.float32)
        with torch.no_grad():
            got = hf_import.bert_forward(module, *(torch.from_numpy(a) for a in (ids, mask, type_ids))).numpy()
        np.testing.assert_allclose(got[mask > 0], theirs[mask > 0], atol=ATOL, rtol=0)
        texts = QUERIES + ["tokyo cafe"]
        np.testing.assert_allclose(
            SentenceEncoder(checkpoint_path=d, max_length=32, device="cpu").encode(texts),
            RefEncoder(checkpoint_path=d, max_length=32).encode(texts), atol=ATOL, rtol=0,
        )
        return
    # transformers always builds a pooler (a missing one is initialized at
    # random), so it is compared only where the checkpoint has one
    model = BertForSequenceClassification.from_pretrained(d).eval()
    with torch.no_grad():
        theirs = model(**t).logits.numpy()
    module, _, _ = hf_import.load_hf_text_model(d, 32, torch.float32, cross=True)
    assert (module.pooler is not None) == pooler
    with torch.no_grad():
        got = hf_import.bert_classify(module, *(torch.from_numpy(a) for a in (ids, mask, type_ids))).numpy()
    if pooler:
        np.testing.assert_allclose(got, theirs, atol=ATOL, rtol=0)
    want = RefCrossEncoder(checkpoint_path=d, max_length=32).predict(PAIRS)
    np.testing.assert_allclose(CrossEncoderModel(checkpoint_path=d, max_length=32, device="cpu").predict(PAIRS),
                               want, atol=ATOL, rtol=0)
