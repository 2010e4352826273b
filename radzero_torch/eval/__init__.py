"""Serving and inverse-geometry helpers."""
