"""Logical-axis rules, row sharding and replica axes (port of the corpus
half of ``repro.distributed``)."""
from .sharding import (DEFAULT_RULES, axis_group, axis_size, corpus_axis,
                       gather_rows, make_rules, register_axis, shard_rows)

__all__ = ["DEFAULT_RULES", "axis_group", "axis_size", "corpus_axis",
           "gather_rows", "make_rules", "register_axis", "shard_rows"]
