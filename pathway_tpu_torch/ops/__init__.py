"""Serve-path ops of the port: exact and IVF stage 1, the IVF rescore
kernel, the fused encode+search serve path, MaxSim, the retrieve ->
rerank pipeline and its dispatch accounting."""
