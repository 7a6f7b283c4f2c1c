"""Model-side pieces of the port: the chunked-attention oracle of the
flash-attention kernel."""
