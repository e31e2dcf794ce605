"""Trainers of the port (generation phase so far)."""
