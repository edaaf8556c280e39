"""Batched hopscotch get."""
