"""Ordered segment sum for PageRankDelta's EDGEMAP on the GPU."""
