"""Blocked online-softmax attention, forward (causal / length / full)."""
