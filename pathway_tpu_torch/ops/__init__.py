"""Stage-1 search of the port: exact and IVF indexes, the IVF rescore
kernel, and the fused encode+search serve path."""
