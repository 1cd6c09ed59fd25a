"""Baseline systems the paper compares against."""

from .cassandra import CassandraCluster, CassandraConfig

__all__ = ["CassandraCluster", "CassandraConfig"]
