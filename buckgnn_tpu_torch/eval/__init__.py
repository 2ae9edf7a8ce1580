"""Serving-side timing of the port."""
