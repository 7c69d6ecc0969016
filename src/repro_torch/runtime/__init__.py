"""Serving runtime of the port: the content-delivery decode service."""
