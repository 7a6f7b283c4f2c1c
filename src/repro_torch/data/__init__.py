"""Ingest, sketch family, corpus store and dataset-search index of the
port's serving path."""
from .dataset_search import DatasetSearchIndex, SearchResult
from .families import (FAMILY_NAMES, CSFamily, DMHFamily, ICWSFamily,
                       JLFamily, PSFamily, TSFamily, make_family, wmh_storage)
from .store import CorpusStore

__all__ = ["CSFamily", "CorpusStore", "DMHFamily", "DatasetSearchIndex",
           "FAMILY_NAMES", "ICWSFamily", "JLFamily", "PSFamily",
           "SearchResult", "TSFamily", "make_family", "wmh_storage"]
