"""Utilities around the port."""
