"""Models of the port: tokenizer, encoder trunk, cross-encoder, sequence
packing, parameter bridge."""
