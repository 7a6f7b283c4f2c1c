"""Ingest, sketch family, corpus store, merge, dataset-search index, the
single-field ICWS ``SketchCorpus`` of the port, and the paper's synthetic
generators."""
from .corpus import SketchCorpus
from .dataset_search import DatasetSearchIndex, SearchResult
from .families import (FAMILY_NAMES, CSFamily, DMHFamily, ICWSFamily,
                       JLFamily, PSFamily, TSFamily, make_family, wmh_storage)
from .merge import (build_sharded, merge_stores, partition_by_key,
                    split_by_key)
from .store import CorpusStore
from .synthetic import (kurtosis, sparse_pair, tfidf_corpus, token_stream,
                        worldbank_like_pair)

__all__ = ["CSFamily", "CorpusStore", "DMHFamily", "DatasetSearchIndex",
           "FAMILY_NAMES", "ICWSFamily", "JLFamily", "PSFamily",
           "SearchResult", "SketchCorpus", "TSFamily", "build_sharded",
           "kurtosis", "make_family", "merge_stores", "partition_by_key",
           "sparse_pair", "split_by_key", "tfidf_corpus", "token_stream",
           "wmh_storage", "worldbank_like_pair"]
