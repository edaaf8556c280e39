"""Synthetic token and request streams."""
