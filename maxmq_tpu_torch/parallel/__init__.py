"""Cluster mode: matchers sharded over a mesh of devices."""
