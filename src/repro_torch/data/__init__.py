"""Ingest, sketch family, corpus store, merge, dataset-search index and
the single-field ICWS ``SketchCorpus`` of the port."""
from .corpus import SketchCorpus
from .dataset_search import DatasetSearchIndex, SearchResult
from .families import (FAMILY_NAMES, CSFamily, DMHFamily, ICWSFamily,
                       JLFamily, PSFamily, TSFamily, make_family, wmh_storage)
from .merge import (build_sharded, merge_stores, partition_by_key,
                    split_by_key)
from .store import CorpusStore

__all__ = ["CSFamily", "CorpusStore", "DMHFamily", "DatasetSearchIndex",
           "FAMILY_NAMES", "ICWSFamily", "JLFamily", "PSFamily",
           "SearchResult", "SketchCorpus", "TSFamily", "build_sharded",
           "make_family", "merge_stores", "partition_by_key",
           "split_by_key", "wmh_storage"]
