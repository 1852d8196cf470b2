"""Models of the port: tokenizer, encoder trunk, parameter bridge."""
