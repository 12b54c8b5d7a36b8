"""Dense decoder model of the port: norms, rope, MLP, paged attention and
the paged mixed step."""
