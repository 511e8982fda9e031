"""Seasons of synthetic episodes, written from a seed (`season`)."""
