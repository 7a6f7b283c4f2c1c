"""Ingest, sketch family, corpus store and dataset-search index of the
port's serving path."""
from .dataset_search import DatasetSearchIndex, SearchResult
from .families import ICWSFamily, make_family, wmh_storage
from .store import CorpusStore

__all__ = ["CorpusStore", "DatasetSearchIndex", "ICWSFamily",
           "SearchResult", "make_family", "wmh_storage"]
