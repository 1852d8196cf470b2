"""Models of the port: tokenizer, encoder trunk and its decode twins,
cross-encoder, generator and its sampling RNG, sequence packing,
parameter bridge."""
