"""Aggregation ops and the fused SAGE layer of the port."""
