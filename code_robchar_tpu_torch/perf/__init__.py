"""Measurement entry points that run on the card."""
