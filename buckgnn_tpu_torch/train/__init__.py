"""Losses, metrics and the eval step of the port."""
