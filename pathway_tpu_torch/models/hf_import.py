"""HF BERT-family checkpoints from a local directory (counterpart of
``pathway_tpu/models/hf_import.py``): ``config.json`` +
``model.safetensors`` + ``vocab.txt``, the ``save_pretrained`` layout of
sentence-transformers embedders and cross-encoders.  Read with the
port's own safetensors reader (``models/safetensors.py``); no HF runtime.

``BertEncoderModule`` (embedder: ``bert_forward`` then ``mean_pool``) and
``BertCrossEncoderModule`` (``bert_classify``: [CLS] -> pooler (tanh) ->
classifier, logit 0) hold the checkpoint's tensors as registered
parameters, so the device-memory ledger counts them.  HF stores a
``Linear`` weight as ``[out, in]``, which is torch's own layout: the
tensors load as they are (the reference transposes them for JAX's
``[in, out]``, ``hf_import.py:131``).

The forward follows the reference op for op, in the checkpoint's dtype
(f32), whatever ``dtype`` the caller gives (``dtype`` only reaches
``TransformerConfig``):

- post-LN blocks; LayerNorm is ``mean((x - mean)^2)`` with the config's
  epsilon (1e-12);
- the key mask is an additive ``-1e9`` bias in ``h.dtype``;
- scores are divided by ``sqrt(head_dim)`` in ``h.dtype``;
- GELU is exact (erf);
- ``mean_pool`` clamps the token count at ``1e-9`` (the in-framework
  trunk clamps at 1).

These are plain torch ops: the reference runs them as one XLA program,
with no Pallas kernel.

``write_bert_checkpoint`` writes a seeded checkpoint in the same layout
(HF's initializer: weights N(0, 0.02), LayerNorm 1 / 0, biases 0) with
the port's safetensors writer, where no trained weights and no HF
runtime are at hand.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .safetensors import load_file, save_file
from .transformer import TransformerConfig
from .wordpiece import WordPieceTokenizer

__all__ = [
    "BertConfig",
    "BertCrossEncoderModule",
    "BertEncoderModule",
    "bert_classify",
    "bert_forward",
    "is_hf_checkpoint",
    "load_bert_checkpoint",
    "load_bert_cross_encoder",
    "load_hf_text_model",
    "mean_pool",
    "write_bert_checkpoint",
]


@dataclass
class BertConfig:
    vocab_size: int
    hidden_size: int
    num_hidden_layers: int
    num_attention_heads: int
    intermediate_size: int
    max_position_embeddings: int
    layer_norm_eps: float = 1e-12
    type_vocab_size: int = 2

    @staticmethod
    def from_json(path: str) -> "BertConfig":
        with open(path) as f:
            raw = json.load(f)
        return BertConfig(
            vocab_size=raw["vocab_size"],
            hidden_size=raw["hidden_size"],
            num_hidden_layers=raw["num_hidden_layers"],
            num_attention_heads=raw["num_attention_heads"],
            intermediate_size=raw["intermediate_size"],
            max_position_embeddings=raw["max_position_embeddings"],
            layer_norm_eps=raw.get("layer_norm_eps", 1e-12),
            type_vocab_size=raw.get("type_vocab_size", 2),
        )


def _layer_norm(x: torch.Tensor, ln: "_LayerNorm", eps: float) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * ln.weight + ln.bias


class _LayerNorm(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))


class _Layer(nn.Module):
    """One post-LN block under HF's names (``encoder.layer.{i}.``)."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        d, f = cfg.hidden_size, cfg.intermediate_size
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(d, d)
        self.value = nn.Linear(d, d)
        self.attn_out = nn.Linear(d, d)
        self.attn_ln = _LayerNorm(d)
        self.ffn_in = nn.Linear(d, f)
        self.ffn_out = nn.Linear(f, d)
        self.ffn_ln = _LayerNorm(d)


# port module name -> HF tensor name, per layer (prefix ``encoder.layer.{i}.``)
_LAYER_NAMES = {
    "query": "attention.self.query",
    "key": "attention.self.key",
    "value": "attention.self.value",
    "attn_out": "attention.output.dense",
    "attn_ln": "attention.output.LayerNorm",
    "ffn_in": "intermediate.dense",
    "ffn_out": "output.dense",
    "ffn_ln": "output.LayerNorm",
}


class _BertTrunk(nn.Module):
    """The embeddings and the blocks; ``forward`` is ``bert_forward``."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.word = nn.Embedding(cfg.vocab_size, d)
        self.position = nn.Embedding(cfg.max_position_embeddings, d)
        self.token_type = nn.Embedding(cfg.type_vocab_size, d)
        self.emb_ln = _LayerNorm(d)
        self.layers = nn.ModuleList(_Layer(cfg) for _ in range(cfg.num_hidden_layers))


def bert_forward(
    trunk: _BertTrunk, ids: torch.Tensor, mask: torch.Tensor, type_ids: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """HF-BERT forward in eval mode: the last hidden state ``[B, L, H]``.
    ``type_ids`` segments sentence pairs (cross-encoders); 0s when
    absent."""
    cfg = trunk.cfg
    B, L = ids.shape
    ids = ids.long()
    if type_ids is None:
        type_ids = torch.zeros_like(ids)
    h = trunk.word(ids) + trunk.position(torch.arange(L, device=ids.device))[None] + trunk.token_type(type_ids.long())
    h = _layer_norm(h, trunk.emb_ln, cfg.layer_norm_eps)
    n_heads = cfg.num_attention_heads
    head_dim = cfg.hidden_size // n_heads
    attn_bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e9).to(h.dtype)  # [B, 1, 1, L]
    scale = torch.sqrt(torch.tensor(head_dim, dtype=h.dtype, device=h.device))

    def split(x: torch.Tensor) -> torch.Tensor:
        return x.reshape(B, L, n_heads, head_dim).transpose(1, 2)

    for layer in trunk.layers:
        q, k, v = layer.query(h), layer.key(h), layer.value(h)
        scores = split(q) @ split(k).transpose(-1, -2)
        scores = scores / scale + attn_bias
        probs = torch.softmax(scores, dim=-1)
        ctx = (probs @ split(v)).transpose(1, 2).reshape(B, L, cfg.hidden_size)
        h = _layer_norm(h + layer.attn_out(ctx), layer.attn_ln, cfg.layer_norm_eps)
        ffn = layer.ffn_out(F.gelu(layer.ffn_in(h), approximate="none"))
        h = _layer_norm(h + ffn, layer.ffn_ln, cfg.layer_norm_eps)
    return h


def mean_pool(hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """sentence-transformers mean pooling: the masked token average
    ``[B, H]``, the count clamped at 1e-9."""
    m = mask[:, :, None].to(hidden.dtype)
    return torch.sum(hidden * m, dim=1) / torch.clamp(torch.sum(m, dim=1), min=1e-9)


class BertEncoderModule(_BertTrunk):
    """Embedder: ``(ids, mask) -> [B, H]`` mean-pooled last hidden state."""

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return mean_pool(bert_forward(self, ids, mask), mask)


class BertCrossEncoderModule(_BertTrunk):
    """``BertForSequenceClassification``: ``(ids, mask, type_ids) -> [B]``
    (a single-logit head's score; a multi-label head's logit 0)."""

    def __init__(self, cfg: BertConfig, n_labels: int, pooler: bool):
        super().__init__(cfg)
        d = cfg.hidden_size
        self.pooler = nn.Linear(d, d) if pooler else None
        self.classifier = nn.Linear(d, n_labels)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor, type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        return bert_classify(self, ids, mask, type_ids)[:, 0]


def bert_classify(
    module: BertCrossEncoderModule, ids: torch.Tensor, mask: torch.Tensor, type_ids: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Classification logits ``[B, n_labels]``: pooler (tanh) over [CLS]
    when the checkpoint has one, then the classifier."""
    cls = bert_forward(module, ids, mask, type_ids)[:, 0, :]
    if module.pooler is not None:
        cls = torch.tanh(module.pooler(cls))
    return module.classifier(cls)


def _load_tensors(path: str) -> Dict[str, np.ndarray]:
    """One safetensors read; a leading ``bert.`` prefix (full-model
    exports) is stripped."""
    raw = load_file(os.path.join(path, "model.safetensors"))
    return {(name[5:] if name.startswith("bert.") else name): value for name, value in raw.items()}


def _state_dict(path: str, cfg: BertConfig, tensors: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """HF tensor names -> the trunk's state dict; a missing tensor raises
    the reference's ``KeyError``."""

    def get(name: str) -> torch.Tensor:
        if name not in tensors:
            raise KeyError(f"checkpoint at {path} lacks tensor {name!r} — only BERT-family encoders are supported")
        return torch.from_numpy(tensors[name])

    sd = {
        "word.weight": get("embeddings.word_embeddings.weight"),
        "position.weight": get("embeddings.position_embeddings.weight"),
        "token_type.weight": get("embeddings.token_type_embeddings.weight"),
        "emb_ln.weight": get("embeddings.LayerNorm.weight"),
        "emb_ln.bias": get("embeddings.LayerNorm.bias"),
    }
    for i in range(cfg.num_hidden_layers):
        for dst, src in _LAYER_NAMES.items():
            for leaf in ("weight", "bias"):
                sd[f"layers.{i}.{dst}.{leaf}"] = get(f"encoder.layer.{i}.{src}.{leaf}")
    return sd


def load_bert_checkpoint(
    path: str, _tensors: Optional[Dict[str, np.ndarray]] = None
) -> Tuple[BertConfig, Dict[str, torch.Tensor]]:
    """An HF BERT-style checkpoint directory -> ``(BertConfig, state dict
    of BertEncoderModule)``.  ``path`` holds ``config.json`` and
    ``model.safetensors``; tensor names follow HF ``BertModel``."""
    cfg = BertConfig.from_json(os.path.join(path, "config.json"))
    tensors = _tensors if _tensors is not None else _load_tensors(path)
    return cfg, _state_dict(path, cfg, tensors)


def load_bert_cross_encoder(path: str) -> Tuple[BertConfig, Dict[str, torch.Tensor]]:
    """An HF ``BertForSequenceClassification`` checkpoint -> ``(BertConfig,
    state dict incl. the classifier and, when present, the pooler)``."""
    tensors = _load_tensors(path)
    cfg, sd = load_bert_checkpoint(path, _tensors=tensors)
    if "classifier.weight" not in tensors:
        raise KeyError(
            f"checkpoint at {path} has no classification head "
            "(classifier.weight) — it is an encoder/embedder export, not a "
            "cross-encoder; use SentenceEncoder(checkpoint_path=...) for it"
        )
    sd["classifier.weight"] = torch.from_numpy(tensors["classifier.weight"])
    sd["classifier.bias"] = torch.from_numpy(tensors["classifier.bias"])
    if "pooler.dense.weight" in tensors:
        sd["pooler.weight"] = torch.from_numpy(tensors["pooler.dense.weight"])
        sd["pooler.bias"] = torch.from_numpy(tensors["pooler.dense.bias"])
    return cfg, sd


def load_hf_text_model(path: str, max_length: int, dtype, cross: bool = False):
    """The shared ``SentenceEncoder`` / ``CrossEncoderModel`` HF set-up:
    ``max_length`` clamped to ``max_position_embeddings``, the vocab's
    tokenizer, the module on the CPU.  Returns ``(module, config,
    tokenizer)``; ``config`` is the ``TransformerConfig`` the model
    reports (``dtype`` reaches only it)."""
    hf_cfg, sd = load_bert_cross_encoder(path) if cross else load_bert_checkpoint(path)
    max_length = min(max_length, hf_cfg.max_position_embeddings)
    config = TransformerConfig(
        vocab_size=hf_cfg.vocab_size,
        d_model=hf_cfg.hidden_size,
        n_heads=hf_cfg.num_attention_heads,
        n_layers=hf_cfg.num_hidden_layers,
        d_ff=hf_cfg.intermediate_size,
        max_len=max_length,
        dtype=dtype,
        pool="mean",
    )
    vocab_file = os.path.join(path, "vocab.txt")
    if not os.path.exists(vocab_file):
        # trained weights + hash-derived token ids = silently garbage
        # embeddings / scores; fail loudly instead
        raise FileNotFoundError(
            f"{path} has model weights but no vocab.txt — export the "
            "tokenizer vocab alongside the checkpoint "
            "(tokenizer.save_vocabulary) so token ids match the weights"
        )
    tokenizer = WordPieceTokenizer(vocab_file, max_length=max_length)
    with torch.device("meta"):  # no init: every tensor comes from the checkpoint
        if cross:
            module = BertCrossEncoderModule(hf_cfg, sd["classifier.weight"].shape[0], "pooler.weight" in sd)
        else:
            module = BertEncoderModule(hf_cfg)
    # the checkpoint's tensors as they are, dtype included: the module
    # computes in the checkpoint's dtype
    module.load_state_dict(sd, strict=True, assign=True)
    return module.eval(), config, tokenizer


def is_hf_checkpoint(path) -> bool:
    return (
        isinstance(path, str)
        and os.path.isdir(path)
        and os.path.exists(os.path.join(path, "config.json"))
        and os.path.exists(os.path.join(path, "model.safetensors"))
    )


def write_bert_checkpoint(
    path: str, cfg: BertConfig, vocab, seed: int = 0, n_labels: Optional[int] = None, pooler: bool = True
) -> None:
    """Write ``config.json``, ``model.safetensors`` and ``vocab.txt`` of a
    seeded BERT into the directory ``path`` (made when missing): a
    ``BertModel`` export, or with ``n_labels`` a
    ``BertForSequenceClassification`` one (``bert.``-prefixed, with the
    pooler when ``pooler``).  ``vocab`` is the list of tokens, one per
    line."""
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    d, f = cfg.hidden_size, cfg.intermediate_size
    tensors: Dict[str, np.ndarray] = {}

    def linear(name: str, d_out: int, d_in: int) -> None:
        tensors[name + ".weight"] = rng.normal(0.0, 0.02, size=(d_out, d_in)).astype(np.float32)
        tensors[name + ".bias"] = np.zeros(d_out, np.float32)

    def layer_norm(name: str) -> None:
        tensors[name + ".weight"] = np.ones(d, np.float32)
        tensors[name + ".bias"] = np.zeros(d, np.float32)

    for name, rows in (("word", cfg.vocab_size), ("position", cfg.max_position_embeddings),
                       ("token_type", cfg.type_vocab_size)):
        tensors[f"embeddings.{name}_embeddings.weight"] = rng.normal(0.0, 0.02, size=(rows, d)).astype(np.float32)
    layer_norm("embeddings.LayerNorm")
    shapes = {"intermediate.dense": (f, d), "output.dense": (d, f)}
    for i in range(cfg.num_hidden_layers):
        for src in _LAYER_NAMES.values():
            if src.endswith("LayerNorm"):
                layer_norm(f"encoder.layer.{i}.{src}")
            else:
                linear(f"encoder.layer.{i}.{src}", *shapes.get(src, (d, d)))
    raw = {
        "model_type": "bert",
        "architectures": ["BertForSequenceClassification" if n_labels else "BertModel"],
        "vocab_size": cfg.vocab_size,
        "hidden_size": d,
        "num_hidden_layers": cfg.num_hidden_layers,
        "num_attention_heads": cfg.num_attention_heads,
        "intermediate_size": f,
        "max_position_embeddings": cfg.max_position_embeddings,
        "type_vocab_size": cfg.type_vocab_size,
        "layer_norm_eps": cfg.layer_norm_eps,
        "hidden_act": "gelu",
        "initializer_range": 0.02,
    }
    if n_labels:
        if pooler:
            linear("pooler.dense", d, d)
        tensors = {"bert." + name: t for name, t in tensors.items()}
        linear("classifier", n_labels, d)
        raw["num_labels"] = n_labels
    save_file(tensors, os.path.join(path, "model.safetensors"), metadata={"format": "pt"})
    with open(os.path.join(path, "config.json"), "w") as fh:
        json.dump(raw, fh, indent=2)
    with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as fh:
        fh.write("\n".join(vocab) + "\n")
