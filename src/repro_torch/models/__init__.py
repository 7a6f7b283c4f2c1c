"""Model side of the port: the dense transformer (``Model``) with its
layers, attention and KV-cache decode, and the chunked-attention oracle of
the flash-attention kernel."""
from .counting import count_active_params, count_params
from .transformer import Model

__all__ = ["Model", "count_params", "count_active_params"]
