"""Masks, batch helpers and decode drivers of the port."""
