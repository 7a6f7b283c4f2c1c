"""Ingest, sketch family, corpus store and dataset-search index of the
port's serving path."""
from .dataset_search import DatasetSearchIndex, SearchResult
from .families import (FAMILY_NAMES, CSFamily, ICWSFamily, JLFamily,
                       make_family, wmh_storage)
from .store import CorpusStore

__all__ = ["CSFamily", "CorpusStore", "DatasetSearchIndex", "FAMILY_NAMES",
           "ICWSFamily", "JLFamily", "SearchResult", "make_family",
           "wmh_storage"]
