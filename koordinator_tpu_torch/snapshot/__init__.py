"""Cluster snapshot structs of the port."""
