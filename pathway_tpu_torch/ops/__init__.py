"""Serve-path ops of the port: exact and IVF stage 1, the IVF rescore
kernel, the fused encode+search serve path, MaxSim, the retrieve ->
rerank pipeline and its dispatch accounting, and the decode path's int8
K/V quantization and row-invariant LayerNorm / readout kernels."""

from .knn import DeviceKnnIndex
from .recompile_guard import RecompileBudgetExceeded, RecompileTripwire, RecompileWarning, guarded_jit
from .retrieve_rerank import CrossEncoderStage, LateInteractionStage, RerankStage, RetrieveRerankPipeline
from .serving import FusedEncodeSearch
from .topk import merge_topk, sharded_topk

__all__ = [
    "CrossEncoderStage",
    "DeviceKnnIndex",
    "FusedEncodeSearch",
    "LateInteractionStage",
    "RecompileBudgetExceeded",
    "RecompileTripwire",
    "RecompileWarning",
    "RerankStage",
    "RetrieveRerankPipeline",
    "guarded_jit",
    "merge_topk",
    "sharded_topk",
]
