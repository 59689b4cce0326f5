"""Geometry, density estimation and sampling utilities."""
