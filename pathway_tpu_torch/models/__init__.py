"""Models of the port: tokenizers (hash and WordPiece), encoder trunk and
its decode twins, cross-encoder, CLIP, generator and its sampling RNG,
sequence packing, parameter bridge, HF checkpoint import and the
safetensors reader / writer."""

from .clip import ClipModel
from .cross_encoder import CrossEncoderModel
from .encoder import SentenceEncoder
from .generator import TextGenerator
from .hf_import import BertConfig, is_hf_checkpoint, load_hf_text_model
from .tokenizer import HashTokenizer
from .transformer import TransformerConfig, TransformerEncoder
from .wordpiece import WordPieceTokenizer

__all__ = [
    "BertConfig",
    "ClipModel",
    "CrossEncoderModel",
    "HashTokenizer",
    "SentenceEncoder",
    "TextGenerator",
    "TransformerConfig",
    "TransformerEncoder",
    "WordPieceTokenizer",
    "is_hf_checkpoint",
    "load_hf_text_model",
]
